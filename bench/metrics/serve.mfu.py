"""The whole serving step's share of the card's peak: the model
operations of every token prefilled and decoded in the window (2 per
projection and MLP weight, 4 D per attended key and query head, the head
where logits are computed), over the window's wall time, against 989
TFLOP/s dense bf16 (H100 SXM)."""

from mindbench.peaks import TENSOR_OPS_S


def read(run):
    if not run.get("flops") or not run.get("wall_s"):
        return None
    return 100.0 * run["flops"] / run["wall_s"] / TENSOR_OPS_S
