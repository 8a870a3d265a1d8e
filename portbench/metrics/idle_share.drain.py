"""Share of the traced window in which no operation ran on the card
(device layer; a backlog cell, so it moves ``msgs_per_s``)."""


def read(record):
    return record["summary"].idle_share()
