"""The device grid of a deployment (port of vox_serve_tpu/parallel/mesh.py).

Data-parallel replicas are whole scheduler daemons (one per card, or per
``tp`` cards), with no traffic between them. Tensor parallelism splits one
replica's backbone over ``tp`` cards, one process per card
(``parallel/ranks.py``), joined by a ``torch.distributed`` group; the
collectives are explicit in the backbone (``models/backbone.py``), where
the JAX package lets GSPMD derive them from its ``('dp', 'tp')`` mesh.
``make_mesh`` keeps that mesh's validation and layout: a ``(dp, tp)``
grid of ``torch.device``s, row r the cards of replica r.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              devices: Optional[list] = None) -> list[list[torch.device]]:
    """The ``(dp, tp)`` grid over ``devices`` (default: every CUDA card of
    the process), in order. ``tp`` None takes all the devices the ``dp``
    replicas can share evenly and warns about the ones left over; too few
    devices raise ``ValueError``, as in the JAX package."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if tp is None:
        tp, rem = divmod(n, dp)
        if tp == 0:
            raise ValueError(
                f"mesh dp={dp} needs at least {dp} devices, have {n}")
        if rem:
            # silent truncation hid cards from the deployment
            logging.getLogger("vox_serve_tpu_torch.parallel").warning(
                "mesh dp=%d over %d devices: %d trailing device(s) unused",
                dp, n, rem)
    if tp < 1 or dp * tp > n:
        raise ValueError(f"mesh dp={dp} x tp={tp} needs {dp * tp} devices, "
                         f"have {n}")
    return [devices[r * tp:(r + 1) * tp] for r in range(dp)]
