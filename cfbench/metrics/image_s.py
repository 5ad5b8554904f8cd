"""Seconds per image request (the steps and the decode), the window's requests' total over their
count."""

from cfbench import readers


def read(run):
    return readers.seconds_per_request(run)
