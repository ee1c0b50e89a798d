"""Molecules trained on over all of the window of streamed epochs
(`Runner.run_epoch`, the epoch `Runner.train` runs): whole epochs,
counted when they end, over the seconds to the last end (host clock,
synchronised). A metric of its own, so that its bound is set from the
spread of the cells that report it."""


def read(window, setup_s):
    return window.graphs / window.seconds if window.seconds > 0 else None
