"""Tokens a second an LM training cell trained: every token of every step
queued in the window, over the host-clock seconds until the last step's
update was done on the card."""

from perfbench.metrics._lm import tokens_per_s


def read(rec):
    return tokens_per_s(rec)
