"""Model FLOPs of the messages answered in the window (each one's real
prompt and its generated tokens), over the window, as a share of the
card's bf16 peak (model step layer)."""

from portbench.flops import PEAK_BF16_FLOPS, request_flops


def read(record):
    answered = record["answered"]
    if not answered:
        return None
    flops = sum(request_flops(record["sizes"], prompt, generated)
                for prompt, generated in answered)
    return 100.0 * flops / record["seconds"] / PEAK_BF16_FLOPS
