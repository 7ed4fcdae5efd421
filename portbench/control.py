"""The control of the benchmark's correctness check.

The reference put in the program's place and computed in bfloat16, the
precision below the float32 the configurations state (intensities,
products and sums; m/z compared in float32): its labels are held against
the float32 reference's exactly as a run holds the program's, so its
``label_disagree`` is the reading a program that stepped down to bfloat16
would give.  A limit must lie below these readings.

    python3 portbench/control.py --workload NAME --seeds N [N ...]

prints one line of JSON a seed.  It runs on the card when there is one.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generator, reference  # noqa: E402
from portbench.run import load_cell  # noqa: E402


def control_reading(config: dict, traffic: dict, seed: int,
                    device) -> dict:
    """label_disagree of the bfloat16 reference against the float32
    reference on the corpus of ``traffic`` drawn from ``seed``."""
    import torch

    settings = reference.exact_settings(config["settings"])
    corpus = generator.quantize(generator.from_traffic(traffic, seed))
    t0 = time.perf_counter()
    ref = reference.cluster(corpus, settings, device)
    t1 = time.perf_counter()
    low = reference.cluster(corpus, settings, device, torch.bfloat16)
    t2 = time.perf_counter()
    return {"seed": seed, "label_disagree": reference.disagreement(low, ref),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    _, config, traffic, _, _, _ = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        reading = control_reading(config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, **reading}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
