"""Set-up time: process start to the window's start, in seconds (host
clock, synchronised): molecules, weights, the port's preprocessing, pack
and upload, captures of the cell's shapes, and in a checkout's first run
the builds."""


def read(window, setup_s):
    return setup_s
