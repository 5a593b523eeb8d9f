"""Multi-host initialization helpers.

The reference has no distributed runtime at all (SURVEY §2.7): its
multi-GPU path is a single-process ``cudaSetDevice`` loop with host-staged
gathers (`gpuhd/multigpu_demo.cc:176-314`).  Here it is
``jax.distributed`` + one global mesh: every process calls
:func:`init_multihost` (idempotent) with the coordinator's address, the
process count and its own id, after which ``jax.devices()`` spans every
process's devices and the sharded codec entry points in
``huffman_jax.parallel`` run unchanged; XLA routes the collectives.

Typical launch (same program in every process)::

    from huffman_jax.utils.distributed import init_multihost
    from huffman_jax.parallel import data_mesh, ils_sharded_certified_encode

    init_multihost("host0:1234", num_processes=2, process_id=RANK)
    mesh = data_mesh()                    # all devices, data axis
    ...

The logic is exercised on the virtual 8-device CPU mesh (tests/).
"""

from __future__ import annotations

import os

import jax

__all__ = ["init_multihost", "is_multihost"]

_INITIALIZED = False


def is_multihost() -> bool:
    return jax.process_count() > 1


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed once, from explicit args or the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    environment variables.

    Safe to call unconditionally: a no-op when already initialized or when
    no coordinator is configured (single process).
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return  # single process
    if num_processes is None:
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(env["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
