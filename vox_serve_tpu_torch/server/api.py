"""APIServer of the port: vox_serve_tpu.server.api.APIServer with its
scheduler spawning pointed at the port's daemon.

Only ``_start_schedulers`` changes. It starts
``python -m vox_serve_tpu_torch.scheduler_entry`` per data-parallel rank,
pins each rank to one card with ``CUDA_VISIBLE_DEVICES`` when there is more
than one rank, and drops the TPU device-pinning variables of the JAX server.
Request routing, ZMQ framing, chunk buffering and /health are inherited.
"""

from __future__ import annotations

import os
import subprocess
import sys

from vox_serve_tpu.server.api import APIError, APIServer as _JaxAPIServer

__all__ = ["APIError", "APIServer"]

_TPU_ENV = ("TPU_VISIBLE_DEVICES", "TPU_CHIPS_PER_PROCESS_BOUNDS",
            "TPU_PROCESS_BOUNDS")


class APIServer(_JaxAPIServer):
    def _start_schedulers(self) -> None:
        for rank in range(self.dp_size):
            env = os.environ.copy()
            for k in _TPU_ENV:
                env.pop(k, None)
            if self.dp_size > 1:
                env["CUDA_VISIBLE_DEVICES"] = str(rank)
            cmd = [
                sys.executable, "-m", "vox_serve_tpu_torch.scheduler_entry",
                "--model", self.model_name,
                "--scheduler-type", self.scheduler_type,
                "--rank", str(rank),
                "--max-batch-size", str(self.max_batch_size),
                "--socket-suffix", self.socket_suffix,
            ]
            for k, v in self.scheduler_args.items():
                flag = "--" + k.replace("_", "-")
                if isinstance(v, bool):
                    if v:
                        cmd.append(flag)
                elif v is not None:
                    cmd.extend([flag, str(v)])
            self.logger.info("starting scheduler rank %d: %s", rank,
                             " ".join(cmd))
            self.scheduler_processes.append(subprocess.Popen(cmd, env=env))
