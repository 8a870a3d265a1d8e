"""Device operations launched in the traced window over the tokens the
engine emitted in it (engine layer)."""


def read(record):
    tokens = record["tokens_traced"]
    if not tokens:
        return None
    return record["summary"].launches / tokens
