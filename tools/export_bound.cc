// A bound for the CSV export: the time to read an export's input columns
// (the files given, read whole into memory), to sort as many 64-bit
// integer keys as there are rows (keys drawn from a fixed seed, sorted in
// one slice a thread and merged pairwise on threads), and to write a
// buffer of the CSV's size to a file.  An export that reads every column,
// orders the rows and writes the rows cannot take less.  The files are
// read once before timing, so the reads are warm.
//
//   g++ -O3 -march=native -std=c++17 -pthread -o bound tools/export_bound.cc
//   ./bound ROWS CSV_BYTES OUT_FILE [COLUMN_FILE...]
//
// Prints, for 1 thread and for every core, the best and median seconds of
// each step over 9 repetitions, and of their sum.
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

template <typename F>
void on_threads(int t, F&& task) {
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(task, i);
  for (auto& th : pool) th.join();
}

// Read every file whole, one file a thread at a time; the bytes read.
size_t read_files(const std::vector<std::string>& paths,
                  std::vector<std::vector<char>>& bufs, int t) {
  std::vector<size_t> got(t, 0);
  on_threads(t, [&](int i) {
    for (size_t f = i; f < paths.size(); f += t) {
      int fd = open(paths[f].c_str(), O_RDONLY);
      if (fd < 0) continue;
      size_t off = 0;
      for (ssize_t r; (r = read(fd, bufs[f].data() + off,
                                bufs[f].size() - off)) > 0;)
        off += static_cast<size_t>(r);
      close(fd);
      got[i] += off;
    }
  });
  size_t total = 0;
  for (size_t g : got) total += g;
  return total;
}

void sort_keys(std::vector<uint64_t>& keys, int t) {
  const size_t n = keys.size();
  std::vector<size_t> bounds(t + 1);
  for (int i = 0; i <= t; ++i) bounds[i] = n * i / t;
  on_threads(t, [&](int i) {
    std::sort(keys.begin() + bounds[i], keys.begin() + bounds[i + 1]);
  });
  while (bounds.size() > 2) {
    std::vector<size_t> next{bounds[0]};
    int merges = static_cast<int>((bounds.size() - 1) / 2);
    for (int m = 0; m < merges; ++m) next.push_back(bounds[2 * m + 2]);
    on_threads(merges, [&](int m) {
      std::inplace_merge(keys.begin() + bounds[2 * m],
                         keys.begin() + bounds[2 * m + 1],
                         keys.begin() + bounds[2 * m + 2]);
    });
    if (bounds.size() % 2 == 0) next.push_back(bounds.back());
    bounds = std::move(next);
  }
}

bool write_file(const char* path, const std::vector<char>& buf) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  size_t off = 0;
  while (off < buf.size()) {
    ssize_t w = write(fd, buf.data() + off, buf.size() - off);
    if (w <= 0) break;
    off += static_cast<size_t>(w);
  }
  close(fd);
  return off == buf.size();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s ROWS CSV_BYTES OUT_FILE [COLUMN_FILE...]\n",
                 argv[0]);
    return 2;
  }
  const size_t rows = std::strtoull(argv[1], nullptr, 10);
  const size_t csv_bytes = std::strtoull(argv[2], nullptr, 10);
  const char* out_path = argv[3];
  std::vector<std::string> paths(argv + 4, argv + argc);
  std::vector<std::vector<char>> bufs;
  for (const auto& p : paths) {
    struct stat st;
    bufs.emplace_back(stat(p.c_str(), &st) == 0 ? st.st_size : 0);
  }
  std::vector<uint64_t> seed_keys(rows);
  std::mt19937_64 rng(262144);
  for (auto& k : seed_keys) k = rng();
  std::vector<char> csv(csv_bytes, 'x');
  for (size_t i = 79; i < csv_bytes; i += 80) csv[i] = '\n';
  read_files(paths, bufs, 1);  // warm

  const int cores = std::max(1u, std::thread::hardware_concurrency());
  for (int t : {1, cores}) {
    std::vector<double> rd, so, wr, sum;
    size_t bytes = 0;
    for (int rep = 0; rep < 9; ++rep) {
      std::vector<uint64_t> keys = seed_keys;
      double t0 = now_s();
      bytes = read_files(paths, bufs, t);
      double t1 = now_s();
      sort_keys(keys, t);
      double t2 = now_s();
      if (!write_file(out_path, csv)) {
        std::fprintf(stderr, "cannot write %s\n", out_path);
        return 1;
      }
      double t3 = now_s();
      rd.push_back(t1 - t0);
      so.push_back(t2 - t1);
      wr.push_back(t3 - t2);
      sum.push_back(t3 - t0);
    }
    auto report = [&](const char* name, std::vector<double> v) {
      std::sort(v.begin(), v.end());
      std::printf("threads %d %-6s best %.6f s median %.6f s\n", t, name,
                  v.front(), v[v.size() / 2]);
    };
    std::printf("threads %d: %zu column bytes, %zu keys, %zu CSV bytes\n",
                t, bytes, rows, csv_bytes);
    report("read", rd);
    report("sort", so);
    report("write", wr);
    report("total", sum);
  }
  unlink(out_path);
  return 0;
}
