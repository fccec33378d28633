"""Whether NCCL takes two ranks on one card.

    python3 nccl_one_card.py

Starts two processes, both on card 0, joins them into one NCCL process
group (a file store in a temporary directory, a 60 s timeout) and runs one
all_reduce of a small tensor; prints the card's name and power limit and
then each rank's outcome (the sum, or the error it raised) as one JSON
line. Every process is stopped within 150 s. Exits 0 whichever way NCCL
decides, 1 without a card. The mesh paths of stereomatch_tpu_torch.parallel
take one rank a card; this records what a second rank on the same card
meets.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, tmp: str) -> None:
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0") * (rank + 1)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        outcome = {"rank": rank, "ok": True, "sum": x.tolist()}
        dist.destroy_process_group()
    except Exception as e:  # the outcome under test: recorded, not raised
        outcome = {"rank": rank, "ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(outcome, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(tmp,), nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 150.0
        try:
            while time.monotonic() < deadline and not ctx.join(timeout=1.0):
                pass
        except mp.ProcessExitedException as e:  # a rank killed by a signal, e.g. NCCL's abort
            print(json.dumps({"exited": str(e)}))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        for rank in range(2):
            path = os.path.join(tmp, f"rank{rank}.json")
            print(open(path).read() if os.path.exists(path) else json.dumps(
                {"rank": rank, "ok": False, "error": "no outcome within 150 s: killed"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
