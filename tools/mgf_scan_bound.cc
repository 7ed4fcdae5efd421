// A bound for MGF ingest: the time of a bare scan of a file held in memory,
// split at line starts into one slice a thread, that finds each newline
// with memchr and parses the two tokens of every line that starts with a
// digit into doubles with std::from_chars.  An ingest that parses, checks
// and preprocesses every peak line cannot take less.  The file is read
// once before timing, so the scan is warm.
//
//   g++ -O3 -march=native -std=c++17 -pthread -o bound tools/mgf_scan_bound.cc
//   ./bound FILE.mgf [REPETITIONS]
//
// Prints, for 1 thread and for every core, the best and median seconds
// and the best rate.
#include <algorithm>
#include <charconv>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

double scan(const char* b, const char* e) {
  double sum = 0;
  while (b < e) {
    const char* nl = static_cast<const char*>(std::memchr(b, '\n', e - b));
    if (nl == nullptr) nl = e;
    if (*b >= '0' && *b <= '9') {
      const char* s = b;
      while (s < nl && *s != ' ' && *s != '\t') ++s;
      double mz = 0, intensity = 0;
      std::from_chars(b, s, mz);
      if (s < nl) std::from_chars(s + 1, nl, intensity);
      sum += mz + intensity;
    }
    b = nl + 1;
  }
  return sum;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s FILE.mgf [REPETITIONS]\n", argv[0]);
    return 2;
  }
  const int reps = argc > 2 ? std::max(1, std::atoi(argv[2])) : 5;
  int fd = open(argv[1], O_RDONLY);
  struct stat st;
  if (fd < 0 || fstat(fd, &st) != 0) {
    std::perror(argv[1]);
    return 1;
  }
  std::string data(static_cast<size_t>(st.st_size), '\0');
  size_t got = 0;
  while (got < data.size()) {
    ssize_t r = pread(fd, &data[got], data.size() - got,
                      static_cast<off_t>(got));
    if (r <= 0) break;
    got += static_cast<size_t>(r);
  }
  close(fd);
  data.resize(got);
  const char* begin = data.data();
  const char* end = begin + data.size();
  const int cores = static_cast<int>(std::thread::hardware_concurrency());
  for (int threads : {1, std::max(cores, 1)}) {
    std::vector<const char*> cut(threads + 1, end);
    cut[0] = begin;
    for (int k = 1; k < threads; ++k) {
      const char* p = begin + data.size() * k / threads;
      const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
      cut[k] = nl != nullptr ? nl + 1 : end;
    }
    std::vector<double> seconds;
    double sink = 0;
    for (int r = 0; r < reps; ++r) {
      std::vector<double> part(threads);
      auto t0 = std::chrono::steady_clock::now();
      std::vector<std::thread> pool;
      for (int k = 0; k < threads; ++k)
        pool.emplace_back([&, k] { part[k] = scan(cut[k], cut[k + 1]); });
      for (auto& t : pool) t.join();
      auto t1 = std::chrono::steady_clock::now();
      for (double v : part) sink += v;
      seconds.push_back(std::chrono::duration<double>(t1 - t0).count());
    }
    std::sort(seconds.begin(), seconds.end());
    std::printf("threads %d bytes %zu best %.6f s median %.6f s "
                "(%.1f MB/s best; checksum %g)\n",
                threads, data.size(), seconds.front(),
                seconds[seconds.size() / 2],
                data.size() / seconds.front() / 1e6, sink);
  }
  return 0;
}
