# -*- coding: utf-8 -*-
#
# Interactive user queries (parity: reference syncopy/shared/queries.py:9-60).

__all__ = ["user_yesno", "user_input"]


def user_yesno(msg, default=None):
    """Ask a yes/no question on stdin; returns bool."""
    valid = {"yes": True, "y": True, "no": False, "n": False}
    if default is None:
        prompt = " [y/n] "
    elif default == "yes":
        prompt = " [Y/n] "
        valid[""] = True
    elif default == "no":
        prompt = " [y/N] "
        valid[""] = False
    else:
        raise ValueError("invalid default answer: '{}'".format(default))
    while True:
        try:
            choice = input(msg + prompt).lower()
        except EOFError:
            return valid.get("", False)
        if choice in valid:
            return valid[choice]


def user_input(msg, valid, default=None):
    """Ask for a choice among `valid` options on stdin."""
    if default is not None and default not in valid:
        raise ValueError("default '{}' not in valid options {}".format(default, valid))
    suffix = " [{}]".format("/".join(v.upper() if v == default else v for v in valid))
    while True:
        try:
            choice = input(msg + suffix + ": ").strip()
        except EOFError:
            return default
        if choice == "" and default is not None:
            return default
        if choice in valid:
            return choice
