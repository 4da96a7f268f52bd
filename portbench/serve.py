"""The port's launcher, started by the harness:
``python -m portbench.serve <launch flags>``.

Runs ``vox_serve_tpu_torch.launch.main`` with its flags as given. The one
difference from ``python -m vox_serve_tpu_torch.launch``: each scheduler
daemon starts as ``python -m portbench.daemon`` (the port's
``scheduler_entry`` with the harness's hooks, see ``daemon.py``) in place
of ``python -m vox_serve_tpu_torch.scheduler_entry``, with the same flags.
"""

from __future__ import annotations

import subprocess
import sys

DAEMON = "vox_serve_tpu_torch.scheduler_entry"


class _Popen(subprocess.Popen):
    """``subprocess.Popen`` that starts the harness's daemon wrapper in
    place of the port's daemon entry."""

    def __init__(self, args, *a, **kw):
        if isinstance(args, list) and DAEMON in args:
            args = list(args)
            args[args.index(DAEMON)] = "portbench.daemon"
        super().__init__(args, *a, **kw)


class _Subprocess:
    """The ``subprocess`` module as the port's API server sees it."""

    def __getattr__(self, name):
        return _Popen if name == "Popen" else getattr(subprocess, name)


def main(argv=None) -> None:
    from vox_serve_tpu_torch import launch
    from vox_serve_tpu_torch.server import api

    api.subprocess = _Subprocess()
    launch.main(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
