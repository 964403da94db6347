"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's in-process multi-task test harness
(``distributed_runtime/rpc/grpc_testlib.h``) — sharding logic is
validated without real multi-chip hardware.
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

import jax  # noqa: E402

# Tests always run on the virtual CPU devices, whatever accelerator the
# machine has.
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_inprocess_compile_state():
    """Drop compiled-program caches between test modules.

    The suite's eager-mode tests compile thousands of small XLA:CPU
    programs; LLVM's in-process JIT state grows monotonically and a
    single pytest process eventually segfaults inside
    backend_compile_and_load (observed deterministically ~116 tests
    in). Clearing JAX's executable caches per module keeps the JIT
    footprint bounded; cross-module cache reuse is negligible anyway.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def mesh8():
    from deeprec_tpu.parallel.mesh import data_mesh

    return data_mesh(8)
