"""Colored terminal narration and the plotting layer's categorical colors
(``multivae_tpu/utils/colors.py``): ANSI colors on a terminal, plain text
otherwise."""

from __future__ import annotations

import sys

_CODES = {
    "title": "\033[1;95m",      # bold magenta
    "subtitle": "\033[1;94m",   # bold blue
    "command": "\033[96m",      # cyan
    "text": "\033[0m",
    "result": "\033[92m",       # green
    "error": "\033[91m",        # red
}
_RESET = "\033[0m"


def _emit(kind: str, text: str) -> None:
    if sys.stdout.isatty():
        print(f"{_CODES[kind]}{text}{_RESET}")
    else:
        print(text)


def print_title(text: str) -> None:
    _emit("title", f"\n== {text} ==")


def print_subtitle(text: str) -> None:
    _emit("subtitle", f"-- {text} --")


def print_command(text: str) -> None:
    _emit("command", text)


def print_text(text: str) -> None:
    _emit("text", str(text))


def print_result(text: str) -> None:
    _emit("result", str(text))


def print_error(text: str) -> None:
    _emit("error", str(text))


# a qualitative palette (tab20-style) for radar/bar plots
def get_color_list(n: int):
    import matplotlib.pyplot as plt
    cmap = plt.get_cmap("tab20")
    return [cmap(i % 20) for i in range(n)]
