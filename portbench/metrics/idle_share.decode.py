"""``idle_share.decode``: The share of the profiled window in which no
operation ran on the card."""
from __future__ import annotations


def read(rec):
    return rec.idle_share()
