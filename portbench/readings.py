"""The readings that a cell's limits are set from, on the card, at the
cell's own size: the program's numbers (the lower readings), the control's
(the reference one precision below the configuration's, in the program's
place) and each planted fault's (the upper readings).

    python -m portbench.readings --workload <cell> --mode <mode>[,<mode>...] --seeds 1,2,3 [--seconds s]

``--mode``: ``program``, ``control``, or a fault of the cell's driver
(``drivers/train.py``'s ``FAULTS`` for training, ``altered_answer`` for
serving). One JSON line per seed and mode, all in one process; a training
seed runs every mode from one set-up and no window. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.workload(args.workload)
    config = harness.config(cell["config"])
    seconds = args.seconds if args.seconds is not None else harness.benchmark()["run_seconds"]

    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    driver = harness.driver(cell["traffic"]["kind"])
    modes = args.mode.split(",")
    name = torch.cuda.get_device_name(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["traffic"]["kind"] == "train":
            for mode, numbers in driver.readings(cell, config, seed, device, modes).items():
                print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                                  "numbers": numbers, "device": name}), flush=True)
            continue
        for mode in modes:
            res = driver.run(cell, config, seed, seconds, False, device,
                             fault=None if mode in ("program", "control") else mode,
                             control=mode == "control")
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                              "numbers": res["numbers"], "checked": res.get("checked"),
                              "e2e": res["e2e"], "detail": res.get("detail"), "device": name}),
                  flush=True)


if __name__ == "__main__":
    main()
