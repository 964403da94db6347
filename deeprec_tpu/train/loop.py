"""Training loop: jitted SPMD train/eval steps.

Replaces the reference's MonitoredTrainingSession + executor stack
(``python/training/monitored_session.py``, ``common_runtime/
direct_session.cc``): there is no graph rewriting or executor policy to
choose — the whole step (lookup, exchange, model, optimizers) is one
XLA program, and the PS architecture is replaced by synchronous SPMD
over a 1-D mesh (SURVEY §2.2).

Two modes share the same step code:
  * single-device ``jit`` (mesh=None)
  * ``shard_map`` over mesh axis "data": batch data-parallel, dense
    params replicated (psum'd grads), EV tables row-sharded.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import optax
from deeprec_tpu.utils import pytree
from jax.sharding import PartitionSpec as P

from deeprec_tpu.feature_column.feature_column import EmbeddingGroup


@pytree.dataclass
class TrainState:
    params: Any                 # dense model params (replicated)
    dense_opt: Any              # optax state (replicated)
    ev: Dict[str, Any]          # EVState per table (row-sharded)
    slots: Dict[str, Any]       # sparse-optimizer slots (row-sharded)
    step: jax.Array             # int32 global step (replicated)


def create_train_state(group: EmbeddingGroup, params, dense_tx,
                       sparse_opt) -> TrainState:
    return TrainState(
        params=params,
        dense_opt=dense_tx.init(params),
        ev=group.create_state(),
        slots=group.init_optimizer(sparse_opt),
        step=jnp.int32(0),
    )


def _spec_tree(ts: TrainState, group: EmbeddingGroup):
    """shard_map in/out specs: sharded-placement EV + slots carry the
    mesh axis on their leading shard dim; replicated-placement tables
    (``group.placement``) and dense params are replicated."""
    axis = group.axis_name
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    per_table = lambda sub: {
        n: jax.tree.map(
            lambda _: P(axis) if group._is_stacked(n) else P(), t)
        for n, t in sub.items()
    }
    return TrainState(
        params=rep(ts.params), dense_opt=rep(ts.dense_opt),
        ev=per_table(ts.ev), slots=per_table(ts.slots), step=P())


def make_train_step(
    group: EmbeddingGroup,
    apply_fn: Callable,           # (params, embs, batch) -> model outputs
    loss_fn: Callable,            # (outputs, batch) -> per-example [B]
    sparse_opt,
    dense_tx: optax.GradientTransformation,
    mesh: Optional[jax.sharding.Mesh] = None,
    donate: bool = True,
    micro_batch_num: int = 1,
    jit_compile: bool = True,
    combine_fn: Optional[Callable] = None,
):
    """Build the jitted train step: (TrainState, batch) -> (TrainState,
    metrics dict). Batch leaves are [B_local*S, ...] global arrays in
    mesh mode (sharded on dim 0).

    ``combine_fn`` overrides ``group.combine`` — pass
    ``group.combine_tables`` (with a matching fused ``apply_fn``) to
    feed the model whole-table matrices instead of per-column slices
    (width-1 bag columns only; requires ``micro_batch_num == 1``).

    ``micro_batch_num > 1`` is the AutoMicroBatch role
    (``common_runtime/graph_execution_state.cc:628``,
    ``docs/Auto-Micro-Batch.md``): the batch is processed as N
    sequential micro-batches with gradient accumulation —
    convergence-equivalent to the N-times batch at a fraction of the
    activation memory.  Embedding lookups still happen once for the
    whole batch (one dedup/exchange), only the dense forward/backward
    is tiled.
    """
    axis = group.axis_name
    if combine_fn is not None and micro_batch_num != 1:
        raise ValueError("combine_fn requires micro_batch_num == 1")
    _combine = combine_fn if combine_fn is not None else group.combine

    def _step(ts: TrainState, batch):
        gs = ts.step
        states, gl = group.lookup_train(ts.ev, batch, gs)
        # Adaptive columns: newly-hot uniques take their trained static
        # row as this step's EV row (value-reuse migration); no-op
        # otherwise.
        states, gl = group.migrate_adaptive(states, gl, ts.params)
        rows = {t: lk.rows for t, lk in gl.lks.items()}

        def loss_of(params, rows, mb_batch, mb_gl):
            embs = _combine(mb_gl, rows, params)
            out = apply_fn(params, embs, mb_batch)
            per_ex = loss_fn(out, mb_batch)
            denom = per_ex.shape[0] * micro_batch_num
            if axis is not None:
                denom = denom * jax.lax.axis_size(axis)
            return jnp.sum(per_ex) / denom, out

        if micro_batch_num == 1:
            (loss, out), (gparams, grows) = jax.value_and_grad(
                loss_of, argnums=(0, 1), has_aux=True)(
                    ts.params, rows, batch, gl)
        else:
            # Tile batch leaves and per-column routing into N
            # micro-batches; accumulate grads with a scan.
            def tile(x):
                return x.reshape((micro_batch_num,
                                  x.shape[0] // micro_batch_num)
                                 + x.shape[1:])

            mb_batches = jax.tree.map(tile, batch)
            mb_cols = {
                name: cl._replace(inverse=tile(cl.inverse),
                                  mask=tile(cl.mask))
                for name, cl in gl.columns.items()
            }

            def body(carry, mb):
                acc_p, acc_r, acc_l = carry
                mb_batch, inv_mask = mb
                cols_i = {
                    n: gl.columns[n]._replace(inverse=inv_mask[n][0],
                                              mask=inv_mask[n][1])
                    for n in gl.columns
                }
                gl_i = gl._replace(columns=cols_i)
                (l, _), (gp, gr) = jax.value_and_grad(
                    loss_of, argnums=(0, 1), has_aux=True)(
                        ts.params, rows, mb_batch, gl_i)
                acc_p = jax.tree.map(jnp.add, acc_p, gp)
                acc_r = jax.tree.map(jnp.add, acc_r, gr)
                return (acc_p, acc_r, acc_l + l), None

            inv_masks = {n: (mb_cols[n].inverse, mb_cols[n].mask)
                         for n in mb_cols}
            zeros_p = jax.tree.map(jnp.zeros_like, ts.params)
            zeros_r = jax.tree.map(jnp.zeros_like, rows)
            (gparams, grows, loss), _ = jax.lax.scan(
                body, (zeros_p, zeros_r, jnp.float32(0.0)),
                (mb_batches, inv_masks))
            out = None
        if axis is not None:
            # NO explicit psum on gparams: params enter shard_map with
            # spec P() (device-invariant), and shard_map's autodiff
            # transposes the invariant->varying broadcast into a psum —
            # the cotangent already IS the global-batch gradient.  An
            # explicit psum here would scale dense grads by axis_size
            # (caught by test_placement's exact mesh-vs-single match).
            loss = jax.lax.psum(loss, axis)
        updates, dopt = dense_tx.update(gparams, ts.dense_opt, ts.params)
        params = optax.apply_updates(ts.params, updates)
        slots, states = group.apply_gradients(
            sparse_opt, ts.slots, states, gl, grows, gs)
        new_ts = TrainState(params=params, dense_opt=dopt, ev=states,
                            slots=slots, step=gs + 1)
        overflow = group.overflow_total(gl)
        if axis is not None:
            overflow = jax.lax.psum(overflow, axis)
        metrics = {"loss": loss, "n_overflow": overflow}
        return new_ts, metrics

    if mesh is None:
        if not jit_compile:
            # Raw step for composition (e.g. lax.scan over a batch
            # pool — see make_epoch_step); caller jits the composite.
            return _step
        return jax.jit(_step, donate_argnums=(0,) if donate else ())

    def wrapped(ts, batch):
        specs = _spec_tree(ts, group)
        batch_specs = jax.tree.map(lambda _: P(axis), batch)
        return jax.shard_map(
            _step, mesh=mesh,
            in_specs=(specs, batch_specs),
            out_specs=(specs, {"loss": P(), "n_overflow": P()}),
        )(ts, batch)

    if not jit_compile:
        return wrapped
    return jax.jit(wrapped, donate_argnums=(0,) if donate else ())


def make_epoch_step(group, apply_fn, loss_fn, sparse_opt, dense_tx,
                    mesh=None, donate: bool = True, n_epochs: int = 1,
                    **kw):
    """One device call that runs whole passes over a stacked batch pool
    via ``lax.scan`` — zero per-step host dispatch.

    Returns ``epoch(ts, stacked_batches) -> (ts, losses)`` where
    ``stacked_batches`` has a leading scan axis K on every leaf
    (``stack_batches`` builds it); losses is [K] for ``n_epochs == 1``,
    [E, K] otherwise (an outer scan repeats the pool E times inside the
    same program): the host enqueues one program per K (or E*K) steps
    instead of K programs.
    """
    raw = make_train_step(group, apply_fn, loss_fn, sparse_opt,
                          dense_tx, mesh=mesh, donate=False,
                          jit_compile=False, **kw)

    def one_epoch(ts, stacked):
        def body(carry, b):
            carry, m = raw(carry, b)
            return carry, m["loss"]
        return jax.lax.scan(body, ts, stacked)

    if n_epochs == 1:
        epoch = one_epoch
    else:
        def epoch(ts, stacked):
            def outer(carry, _):
                return one_epoch(carry, stacked)
            return jax.lax.scan(outer, ts, None, length=n_epochs)

    return jax.jit(epoch, donate_argnums=(0,) if donate else ())


def stack_batches(batches):
    """Stack a list of same-shape batch dicts along a new scan axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *batches)


def make_eval_step(group: EmbeddingGroup, apply_fn, mesh=None):
    """(TrainState, batch) -> model outputs (no mutation)."""
    axis = group.axis_name

    def _eval(ts: TrainState, batch):
        # Inference lookups: no insert/count. Reuse lookup_train's
        # routing but drop state mutations by discarding the new state.
        from deeprec_tpu.embedding import lookup as lkup
        from deeprec_tpu.embedding import sharded as shlib
        from deeprec_tpu.embedding import variable as ev
        from deeprec_tpu.feature_column import feature_column as fclib

        embs = {}
        by_table = {}
        for c in group.embedding:
            by_table.setdefault(group.physical_table_of(c), []).append(c)
        for tname, tcols in by_table.items():
            cfg = group.tables[tname]
            ids_hi, ids_lo, widths = group._packed_view(batch, tname,
                                                        tcols)
            import deeprec_tpu.utils.keys as keylib
            mask = ~((ids_hi == keylib.EMPTY_HI)
                     & (ids_lo == keylib.EMPTY_LO))
            stacked = group._is_stacked(tname)
            state = (shlib.local_of(ts.ev[tname]) if stacked
                     else ts.ev[tname])
            B, L = ids_hi.shape
            if cfg.adaptive_hot_threshold is not None:
                # Adaptive: resident-and-hot ids read their EV row,
                # everything else its static bucket.  Sharded: the
                # merge happens on the owner shard (static replicated).
                from deeprec_tpu.embedding import adaptive as adlib
                static = fclib.EmbeddingGroup._adaptive_static(
                    ts.params, tname)
                if stacked:
                    local_rows, inverse, _ = \
                        adlib.lookup_infer_rows_sharded(
                            cfg, state, ids_hi, ids_lo, static,
                            axis_name=axis,
                            hot_threshold=cfg.adaptive_hot_threshold,
                            num_buckets=cfg.adaptive_buckets,
                            salt=group.salts[tname],
                            capacity_factor=group.capacity_factor)
                else:
                    local_rows = adlib.lookup_infer(
                        cfg, state, ids_hi, ids_lo, static,
                        hot_threshold=cfg.adaptive_hot_threshold,
                        num_buckets=cfg.adaptive_buckets,
                        salt=group.salts[tname])
                    inverse = jnp.arange(B * L).reshape(B, L)
            elif stacked and cfg.static_buckets:
                # Row-sharded static bucket table: dedup global slots,
                # mod-route to owners, exchange rows back.
                local_rows, inverse, _ = shlib.lookup_rows_infer_static(
                    cfg, state, ids_hi, ids_lo, axis_name=axis,
                    capacity_factor=group.capacity_factor)
            elif stacked:
                # Shared sharded read path (the bag_lookup_infer core) —
                # returns per-unique rows + inverse for column slicing.
                local_rows, inverse, _ = shlib.lookup_rows_infer(
                    cfg, state, ids_hi, ids_lo, axis_name=axis,
                    capacity_factor=group.capacity_factor)
            else:
                # Unsharded or replicated placement: the full table is
                # local — plain lookup, no collective.
                local_rows = ev.lookup(cfg, state, ids_hi.reshape(-1),
                                       ids_lo.reshape(-1))
                inverse = jnp.arange(B * L).reshape(B, L)
            off = 0
            for c, w in zip(tcols, widths):
                inv_c = inverse[:, off:off + w]
                m_c = mask[:, off:off + w]
                if isinstance(c, fclib.SequenceEmbeddingColumn):
                    seq = local_rows[inv_c] * m_c[..., None].astype(
                        local_rows.dtype)
                    embs[c.name] = (seq, m_c)
                else:
                    cw = (jnp.asarray(batch[c.weight_name])
                          if getattr(c, "weight_name", None) else None)
                    embs[c.name] = lkup.combine_bags(
                        local_rows, inv_c, m_c, c.combiner, weights=cw)
                off += w
            hname = getattr(group, "_dyn_hot", {}).get(tname)
            if hname is not None:
                # Dyn-dim split: read the hot-block sibling with the
                # same ids and concatenate (cold keys read defaults =
                # zeros there).
                hcfg = group.tables[hname]
                if group._is_stacked(hname):
                    hstate = shlib.local_of(ts.ev[hname])
                    hrows, hinv, _ = shlib.lookup_rows_infer(
                        hcfg, hstate, ids_hi, ids_lo, axis_name=axis,
                        capacity_factor=group.capacity_factor)
                else:
                    hrows = ev.lookup(hcfg, ts.ev[hname],
                                      ids_hi.reshape(-1),
                                      ids_lo.reshape(-1))
                    # Per-occurrence rows — identity inverse (the base
                    # table's ``inverse`` may be per-unique when its
                    # placement differs from the hot sibling's).
                    hinv = jnp.arange(B * L).reshape(B, L)
                off = 0
                for c, w in zip(tcols, widths):
                    inv_c = hinv[:, off:off + w]
                    m_c = mask[:, off:off + w]
                    if isinstance(c, fclib.SequenceEmbeddingColumn):
                        hseq = hrows[inv_c] * m_c[..., None].astype(
                            hrows.dtype)
                        seq, m0 = embs[c.name]
                        embs[c.name] = (jnp.concatenate(
                            [seq, hseq], axis=-1), m0)
                    else:
                        cw = (jnp.asarray(batch[c.weight_name])
                              if getattr(c, "weight_name", None)
                              else None)
                        hbag = lkup.combine_bags(
                            hrows, inv_c, m_c, c.combiner, weights=cw)
                        embs[c.name] = jnp.concatenate(
                            [embs[c.name], hbag], axis=-1)
                    off += w
        return apply_fn(ts.params, embs, batch)

    if mesh is None:
        return jax.jit(_eval)

    def wrapped(ts, batch):
        specs = _spec_tree(ts, group)
        batch_specs = jax.tree.map(lambda _: P(axis), batch)
        return jax.shard_map(
            _eval, mesh=mesh,
            in_specs=(specs, batch_specs),
            out_specs=P(axis),
        )(ts, batch)

    return jax.jit(wrapped)
