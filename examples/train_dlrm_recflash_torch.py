"""End-to-end example: train the DLRM with the RecFlash layout on the port.

The PyTorch/CUDA counterpart of ``examples/train_dlrm_recflash.py``: a few
hundred steps of CTR training on synthetic Criteo-like data with the
frequency-remapped tables (AF remap), row-wise adagrad on the tables, AdamW
on the MLPs, and the fault-tolerant TrainLoop (atomic checkpoints +
resume), the forward through the port's two hand-written kernels. It
imports no JAX. Identical to:

    PYTHONPATH=src python -m repro_torch.launch.train --model dlrm --steps 300

On the card by default; add ``--device cpu`` to run the kernels' plain
versions on the CPU. Extra flags are passed on.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    sys.argv = [sys.argv[0], "--model", "dlrm", "--steps", "300",
                "--batch", "256", "--ckpt-dir",
                os.path.join(tempfile.gettempdir(), "recflash_dlrm_torch_ckpt"),
                *sys.argv[1:]]
    raise SystemExit(main())
