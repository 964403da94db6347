"""Multi-host (pod-slice) initialization and input sharding helpers.

The reference scales across machines with PS jobs and cluster specs
(`tf.train.ClusterSpec`, K8s launchers under ``modelzoo/*/
distribute_k8s/``). The equivalent here is much smaller: every host
runs the SAME SPMD program; `jax.distributed.initialize` wires the
hosts into one runtime, the mesh spans every device of every host
(collectives within and across hosts are the runtime's), and each host
feeds only its local shard of the global batch.

Typical launch (same on every host). On GPU hosts nothing in the
environment tells JAX about the cluster: pass the coordinator address
(``host:port`` of process 0), the process count and this process's id
explicitly:

    from deeprec_tpu.parallel import multihost
    multihost.initialize("10.0.0.1:1234", num_processes=2, process_id=0)
    mesh = multihost.global_data_mesh()
    group = EmbeddingGroup(cols, axis_name="data",
                           num_shards=mesh.devices.size)
    step = make_train_step(..., mesh=mesh)
    for host_batch in multihost.shard_iterator(files, parse):
        global_batch = multihost.host_local_to_global(mesh, host_batch)
        ts, m = step(ts, global_batch)
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """`jax.distributed.initialize` wrapper; safe no-op when
    single-process (tests, one host)."""
    if num_processes in (None, 1) and coordinator_address is None \
            and jax.process_count() == 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def global_data_mesh(axis_name: str = "data") -> jax.sharding.Mesh:
    """1-D mesh over every device of every host."""
    from deeprec_tpu.parallel.mesh import make_mesh
    return make_mesh((len(jax.devices()),), (axis_name,))


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """Static per-host partition of a work list (files, shards) —
    round-robin, the simple alternative to the WorkQueue server."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def shard_iterator(items: Sequence, make_batches: Callable[[object],
                   Iterator], **shard_kw) -> Iterator:
    """Iterate batches from this host's share of the work list."""
    for item in process_shard(items, **shard_kw):
        yield from make_batches(item)


def host_local_to_global(mesh: jax.sharding.Mesh, host_batch,
                         axis_name: str = "data"):
    """Assemble per-host local batches into one global batch-sharded
    array tree (`jax.make_array_from_process_local_data`): each host
    contributes its [B_local, ...] slice of the global [B, ...] batch.
    Single-process: equivalent to device_put with batch sharding."""
    sharding = NamedSharding(mesh, P(axis_name))

    def put(x):
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x))

    return jax.tree.map(put, host_batch)
