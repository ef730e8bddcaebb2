"""mfu: the whole step's share of the card's peak: the model's forward
FLOPs per sample (its module's ``Model.flops_per_sample``; for ``dlrm``: 2
a multiply-add of the MLPs, 2 x embed_dim for each distinct pair the dot
interaction multiplies, 1 a row element each SLS bag adds) times the
window's samples per second, over 67 TFLOP/s, the float32 peak of one H100
SXM off the tensor cores at its 700 W limit. Both configurations compute
in float32 with TF32 off."""

from recbench import arith

PEAK_FLOPS = arith.F32_FLOPS


def read(run):
    if not run.samples or run.mode != "bulk":
        return None
    f = run.cell.model.flops_per_sample()
    return 100.0 * f * run.samples / run.window_s / PEAK_FLOPS
