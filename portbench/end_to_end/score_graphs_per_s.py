"""Molecules answered over all of the scoring window (host clock), to the
last request's end."""


def read(window, setup_s):
    return window.graphs / window.seconds if window.seconds > 0 else None
