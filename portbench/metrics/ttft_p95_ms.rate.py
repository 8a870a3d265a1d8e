"""95th percentile, over the requests due in the window, of the time from
due to the lifecycle registry's ``first_token`` stamp (worker /
admission layer)."""

import numpy as np


def read(record):
    samples = record["first_token_ms"]
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples), 95))
