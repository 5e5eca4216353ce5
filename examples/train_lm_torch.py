"""Example: train a reduced LM (any of the 10 assigned architectures) for
a few hundred steps with checkpoint/resume — the torch arm of
`examples/train_lm.py`, on the port's launcher.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-32b --steps 50
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

It runs on the card unless `--device cpu` is given.  Checkpoints go to
`repro_torch_train_ck` in the temporary directory; a second run resumes
from the last one.
"""
import os
import pathlib
import subprocess
import sys
import tempfile

if __name__ == "__main__":
    args = sys.argv[1:] or ["--arch", "qwen3-32b"]
    ck = os.path.join(tempfile.gettempdir(), "repro_torch_train_ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--steps", "50", "--batch", "4", "--seq", "64",
           "--ckpt-dir", ck, "--ckpt-every", "20", *args]
    print("+", " ".join(cmd))
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    raise SystemExit(subprocess.call(cmd, env=dict(os.environ,
                                                   PYTHONPATH=str(src))))
