"""The examples' device: the card unless ``--cpu`` is given."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device() -> str:
    return "cpu" if "--cpu" in sys.argv else "cuda"


def arg_after(flag):
    """The argument after ``flag`` on the command line, or None."""
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else None
