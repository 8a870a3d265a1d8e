"""Share of the traced window in which no operation ran on the card
(device layer; a rate cell, so it moves ``reply_p95_ms``)."""


def read(record):
    return record["summary"].idle_share()
