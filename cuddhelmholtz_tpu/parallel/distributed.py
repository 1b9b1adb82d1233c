"""Multi-host execution entry: ``jax.distributed`` wiring + hybrid meshes.

The reference is strictly single-GPU; its multi-node story is an aspirational
comment (``/root/reference/include/Mesh2D.hpp:108-109,237-239``).  This
framework runs multi-process the standard JAX way:

  * every process calls :func:`initialize_from_env` once at startup with
    the coordinator address, process count and process id (explicit
    arguments or ``CUDDH_*`` environment variables);
  * :func:`hybrid_device_mesh` builds a 2-axis ``(dcn, ici)`` mesh: the
    outer axis runs across processes, the inner axis over the devices of
    one process.  Shardings that place neighbouring subdomains on the same
    inner block keep the DDH trace exchange within a process; only the
    ``psum`` tree's top level crosses processes.

Multi-process execution is validated on one machine by spawning local CPU
processes (Gloo collectives), see ``spawn_cpu_processes`` and
``tests/test_multiprocess.py`` / ``__graft_entry__.dryrun_multiprocess``.
"""

from __future__ import annotations

import os

import numpy as np


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize ``jax.distributed`` for multi-host runs.

    Arguments default to the ``CUDDH_COORDINATOR`` / ``CUDDH_NUM_PROCESSES``
    / ``CUDDH_PROCESS_ID`` environment variables; when none are given this
    is a single-process run and a no-op returning False (unless another
    initializer already ran).  Safe to call twice (second call is ignored).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("CUDDH_COORDINATOR")
    if num_processes is None and "CUDDH_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["CUDDH_NUM_PROCESSES"])
    if process_id is None and "CUDDH_PROCESS_ID" in os.environ:
        process_id = int(os.environ["CUDDH_PROCESS_ID"])

    if _already_initialized():
        # Never silently ignore mismatched explicit parameters against a
        # live client: the caller would believe their topology was applied.
        if num_processes is not None or process_id is not None:
            import jax as _jax

            live = (_jax.process_count(), _jax.process_index())
            want = (num_processes, process_id)
            if (num_processes is not None and live[0] != num_processes) or (
                process_id is not None and live[1] != process_id
            ):
                raise RuntimeError(
                    f"jax.distributed already initialized with "
                    f"(num_processes, process_id)={live}, but "
                    f"initialize_from_env was asked for {want}; initialize "
                    f"must happen once per process with consistent settings"
                )
        return True

    if coordinator_address is None and num_processes is None:
        return False

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # raced with another initializer
        # jax 0.9 raises "distributed.initialize should only be called once.";
        # older versions said "already initialized"
        if "already" not in str(e) and "once" not in str(e):
            raise
    return True


def _already_initialized() -> bool:
    """Whether ``jax.distributed`` is live in this process (any initializer)."""
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:
        return False


def hybrid_device_mesh(
    ici_per_group: int | None = None,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
):
    """A 2-axis ``(dcn, ici)`` mesh over all global devices.

    Multi-process: one outer group per process, holding that process's local
    devices.  Single process: the device list is reshaped to
    ``(n // ici_per_group, ici_per_group)`` so the same program shape can
    be exercised on a simulated CPU mesh.
    """
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n_proc = jax.process_count()
    if n_proc > 1:
        per_host = len(devs) // n_proc
        arr = np.array(
            sorted(devs, key=lambda d: (d.process_index, d.id))
        ).reshape(n_proc, per_host)
        return Mesh(arr, (dcn_axis, ici_axis))
    if ici_per_group is None:
        ici_per_group = len(devs)
    if len(devs) % ici_per_group:
        raise ValueError("device count not divisible by ici_per_group")
    arr = np.array(devs).reshape(len(devs) // ici_per_group, ici_per_group)
    return Mesh(arr, (dcn_axis, ici_axis))


def spawn_cpu_processes(worker_path: str, n_procs: int, devs_per_proc: int, *args, timeout: float = 600.0, port: int | None = None):
    """Run ``worker_path`` in ``n_procs`` CPU processes wired together with
    ``jax.distributed`` (Gloo), each simulating ``devs_per_proc`` devices.

    Each worker receives ``[process_id, n_procs, devs_per_proc, port, *args]``
    as argv and must set up JAX itself (see tests/mp_worker.py).  Returns the
    list of (returncode, combined output) per process.  ``port=None`` (the
    default) picks a free coordinator port so concurrent runs don't collide.
    """
    import subprocess
    import sys

    if port is None:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                worker_path,
                str(i),
                str(n_procs),
                str(devs_per_proc),
                str(port),
                *map(str, args),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(n_procs)
    ]
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        results.append((p.returncode, out))
    return results
