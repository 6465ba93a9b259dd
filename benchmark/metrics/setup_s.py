"""Seconds from the process's start to the window's."""


def read(rec):
    return rec["setup_s"]
