"""ANSI-colored console logger.

Deliberately a tiny print-based logger rather than ``logging``/absl, matching
the reference's choice (reference: nlt/util/logging.py:15-17) so output stays
readable when many host data-loader threads log concurrently.
"""

import sys
import threading

_COLORS = {
    "info": "\033[92m",     # green
    "warn": "\033[93m",     # yellow
    "error": "\033[91m",    # red
    "debug": "\033[95m",    # magenta
}
_ENDC = "\033[0m"

_print_lock = threading.Lock()


class Logger:
    def __init__(self, loggee=None, debug_mode=False):
        self.loggee = loggee
        self.debug_mode = debug_mode

    def _log(self, level, msg, *args):
        if args:
            msg = msg % args
        prefix = "[%s] " % self.loggee if self.loggee else ""
        color = _COLORS[level]
        with _print_lock:
            print(
                "%s%s%s%s" % (color, prefix, msg, _ENDC),
                file=sys.stderr if level == "error" else sys.stdout,
                flush=True)

    def info(self, msg, *args):
        self._log("info", msg, *args)

    def warn(self, msg, *args):
        self._log("warn", msg, *args)

    def warning(self, msg, *args):
        self._log("warn", msg, *args)

    def error(self, msg, *args):
        self._log("error", msg, *args)

    def debug(self, msg, *args):
        if self.debug_mode:
            self._log("debug", msg, *args)
