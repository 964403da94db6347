"""Real 2-process distributed training test (VERDICT r1 item 6).

Spawns two `jax.distributed` CPU processes (4 virtual devices each,
8-device global mesh), runs the shared sharded model via
``multihost.initialize`` + ``host_local_to_global``, and asserts the
losses match the single-process 8-device run bit-for-step. This is the
analog of the reference's in-process multi-task server tests
(``distributed_runtime/rpc/grpc_testlib.h``,
``grpc_session_test.cc``) — multi-process collectives + per-host batch
assembly without real multi-chip hardware.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _twoprocess_common as common


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_losses(mesh8):
    from deeprec_tpu.feature_column.feature_column import SparseIds
    from deeprec_tpu.parallel import multihost
    import jax

    group, ts, step = common.build_group_and_step(mesh8)
    losses = []
    for i in range(common.N_STEPS):
        ids, label = common.global_batch_np(i)
        gb = multihost.host_local_to_global(
            mesh8, {"f": SparseIds.from_numpy(ids), "label": label})
        ts, m = step(ts, gb)
        losses.append(float(jax.device_get(m["loss"])))
    return losses


def test_two_process_matches_single_process(mesh8, tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(here, "_twoprocess_driver.py")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # driver sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    logs = []
    for pid in range(2):
        log = open(tmp_path / f"proc{pid}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, driver, str(port), str(pid)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here))
    rc = [p.wait(timeout=540) for p in procs]

    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    assert rc == [0, 0], f"driver failed:\n{outs[0]}\n---\n{outs[1]}"

    losses = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("LOSSES ")]
        assert line, out
        losses.append(json.loads(line[-1][len("LOSSES "):]))
    # Both processes observe the same replicated loss...
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    # ...and it matches the single-process 8-device run.
    ref = _single_process_losses(mesh8)
    np.testing.assert_allclose(losses[0], ref, rtol=1e-5)
