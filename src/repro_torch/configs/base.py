"""The arch registry: each registered architecture is an ``ArchBundle``
(port of ``repro.configs.base``).

A bundle owns what a launcher needs per (arch x shape) cell:

* ``init``: the param init at full size (on the ``meta`` device it builds
  shapes only, as the reference's dry-run takes ``jax.eval_shape``);
* ``steps[shape]``: a ``StepDef`` whose ``make_fn(bundle, mesh,
  multi_pod)`` builds the cell's plan (``lm_common.CellPlan``);
* ``param_rules`` / ``opt_rules``: path-substring -> ``PartitionSpec``
  rules (``distributed.shardings.make_param_specs``); opt rules default to
  the param rules and may add ZeRO-style axes for optimizer state;
* ``model_flops[shape]``: MODEL_FLOPS (6ND for LM train, 2ND inference;
  analytic for the recsys and GNN archs).

The registry holds the reference's thirteen archs: the five LMs, the five
DLRMs (dlrm-mlperf, dlrm-rm2, rmc1-3), DIN, BERT4Rec and GraphSAGE. The
arch modules register on import of ``all_archs``, which ``get_arch`` and
``list_archs`` import lazily, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.distributed.shardings import P


@dataclasses.dataclass
class StepDef:
    """One cell of a bundle (``repro/configs/base.py:24-33``)."""

    kind: str                                  # train | serve | prefill | decode
    make_fn: Callable[..., Any] | None         # (bundle, mesh, multi_pod) -> plan
    input_specs: Callable[[bool], tuple] | None  # multi_pod -> args
    donate: tuple = ()                         # donated argnums
    static: tuple = ()                         # static argnums
    skip: str | None = None                    # reason if the cell is skipped
    batch_arg_axes: dict | None = None         # overrides for batch sharding


@dataclasses.dataclass
class ArchBundle:
    """An arch and its cells (``repro/configs/base.py:35-53``)."""

    name: str
    family: str                                # lm | gnn | recsys
    cfg: Any
    init: Callable
    steps: dict[str, StepDef]
    param_rules: list
    opt_rules: list | None = None
    model_flops: dict[str, float] | None = None
    optimizer: Any = None                      # repro_torch.optim.Optimizer
    notes: str = ""

    def rules_for_opt(self):
        return self.opt_rules if self.opt_rules is not None \
            else self.param_rules


_REGISTRY: dict[str, Callable[[], ArchBundle]] = {}


def register(name: str):
    """Register a bundle builder as ``name`` (``repro/configs/base.py:56-60``).
    """
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ArchBundle:
    """A new bundle of the registered arch ``name``
    (``repro/configs/base.py:63-67``)."""
    import repro_torch.configs.all_archs  # noqa: F401  (populates it)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    """The registered archs, sorted (``repro/configs/base.py:70-72``): the
    reference's thirteen."""
    import repro_torch.configs.all_archs  # noqa: F401
    return sorted(_REGISTRY)


# shared PartitionSpec shorthands
REPL = P()


def lm_shapes():
    """The LM-family shape set (train/prefill/decode; long_500k noted)
    (``repro/configs/base.py:79-87``)."""
    return {
        "train_4k": dict(seq_len=4096, global_batch=256),
        "prefill_32k": dict(seq_len=32768, global_batch=32),
        "decode_32k": dict(seq_len=32768, global_batch=128),
        # long_500k: all five assigned LM archs are pure full-attention
        # (GQA/MLA) -> skipped; see DESIGN.md §4.
    }


LONG_500K_SKIP = ("long_500k needs sub-quadratic attention; this arch is "
                  "pure full-attention (GQA/MLA) — skipped per assignment "
                  "rule, documented in DESIGN.md §4")
