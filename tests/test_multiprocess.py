"""Multi-host entry: jax.distributed wiring + ShardedDDH across processes.

SURVEY.md section 7 step 7: the reference has no distributed path at all;
the framework must initialise ``jax.distributed`` and run its sharded
solvers over a 2-axis (process, local device) mesh.  This spawns local
CPU processes wired with Gloo — the standard JAX pattern for testing
cross-process collectives — and checks ShardedDDH agrees with the
single-process reference bit-for-near (fp32 reduction order).
"""

import os

import pytest

from cuddhelmholtz_tpu.parallel.distributed import spawn_cpu_processes

WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")


def test_sharded_ddh_across_processes():
    results = spawn_cpu_processes(WORKER, n_procs=2, devs_per_proc=2)
    for rc, out in results:
        assert rc == 0, out[-2000:]
        assert "MULTIPROCESS_OK" in out, out[-2000:]
