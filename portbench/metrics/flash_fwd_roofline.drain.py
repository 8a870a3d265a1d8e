"""The flash forward's share of its roofline at the inserts in the traced
window: the least time the chip needs for the attention of each insert's
real prompts (every layer; causal pairs inside the window), over the
device time of the ``flash_fwd_kernel`` launches (kernels layer)."""

from portbench.flops import flash_fwd_work, least_seconds

KERNEL = "flash_fwd_kernel"


def read(record):
    seconds = record["summary"].kernel_seconds(KERNEL)
    inserts = record["inserts_traced"] or []
    if seconds <= 0 or not inserts:
        return None
    sizes = record["sizes"]
    least = sum(least_seconds(*flash_fwd_work(sizes, length))
                for lengths in inserts for length in lengths)
    return 100.0 * sizes.n_layers * least / seconds
