"""mlp_layer_ms.bulk: device milliseconds per step of every operation
launched inside the ``dlrm.bot_mlp`` and ``dlrm.top_mlp`` spans in the
traced window: the products, their split-K reductions, the bias adds, the
ReLUs, any cast (``recbench/spans.py`` pairs launches with operations)."""

from recbench import spans


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    s = spans.device_s(t, (spans.BOT_MLP, spans.TOP_MLP))
    return None if s is None else 1e3 * s / t.steps
