"""Train a small LM with the PyTorch port's fault-tolerant driver
(checkpoint/restart): the port's counterpart of ``examples/train_lm.py``,
at its sizes (smoke ``smollm-135m``, 60 steps of 8 x 64 tokens, a
checkpoint every 20 steps).  Checkpoints go to a temporary directory,
removed at the end.

  PYTHONPATH=src python examples/torch_train_lm.py                # card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu

The last stdout line is one JSON object: the final loss, the first
step's, and the device it ran on.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.platform import resolve_device  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train.run_with_restarts(
            arch="smollm-135m", steps=60, ckpt_dir=ckpt_dir, smoke=True,
            batch=8, seq=64, ckpt_every=20, device=dev)
    print(f"final loss: {out['final_loss']:.4f}", flush=True)
    return {"final_loss": out["final_loss"], "first_loss": out["losses"][0],
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
