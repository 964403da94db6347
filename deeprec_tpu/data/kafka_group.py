"""Kafka consumer-group coordination: partition rebalance + group offsets.

Role of the reference's ``KafkaGroupIODataset`` (``docs/KafkaDataset.md``,
``python/data/ops/readers.py``): several online-learning workers share
one topic set; partitions rebalance across live workers and committed
offsets survive worker churn, so each record trains exactly once per
group.

The reference delegates this to Kafka's broker-side group protocol
(JoinGroup/SyncGroup/Heartbeat/OffsetCommit).  This rebuild keeps
the dependency-free wire client (``kafka_protocol.py``) for the DATA
plane and plays the COORDINATION plane with its own tiny service — the
same architectural move as ``WorkQueue`` (the reference's elastic
sharding, ``python/ops/work_queue.py:113``): a socket server any worker
can reach, here speaking lease/heartbeat/commit instead of take().

Semantics:
  * membership by heartbeat — a member missing ``session_timeout``
    seconds is dropped and its partitions rebalance;
  * assignment = round-robin of (topic, partition) over members sorted
    by id (deterministic; the reference's RangeAssignor analog);
  * rebalances bump a GENERATION; consumers detect the bump on their
    next heartbeat, re-seek newly assigned partitions to the group's
    committed offsets, and drop revoked ones;
  * offsets commit per batch delivered to the trainer (at-least-once
    across ungraceful deaths, exactly-once under graceful leave —
    matching Kafka group semantics).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeprec_tpu.data import kafka_protocol
from deeprec_tpu.data.work_queue import _recv_msg, _send_msg


class GroupCoordinator:
    """In-process coordinator state (wrap with
    :class:`GroupCoordinatorServer` for cross-worker use)."""

    def __init__(self, partitions: Sequence[Tuple[str, int]],
                 session_timeout: float = 10.0):
        self._partitions = sorted(partitions)
        self._timeout = session_timeout
        self._members: Dict[str, float] = {}     # id -> last heartbeat
        self._generation = 0
        self._offsets: Dict[Tuple[str, int], int] = {}
        # RLock: state() reads committed() under the same lock.
        self._lock = threading.RLock()

    # -- membership -------------------------------------------------------
    def _expire(self, now: float):
        dead = [m for m, t in self._members.items()
                if now - t > self._timeout]
        for m in dead:
            del self._members[m]
        if dead:
            self._generation += 1

    def _assignment(self, member: str) -> List[Tuple[str, int]]:
        members = sorted(self._members)
        return [tp for i, tp in enumerate(self._partitions)
                if members and members[i % len(members)] == member]

    def join(self, member: str) -> dict:
        with self._lock:
            now = time.time()
            self._expire(now)
            if member not in self._members:
                self._generation += 1
            self._members[member] = now
            return self._view(member)

    def heartbeat(self, member: str) -> dict:
        with self._lock:
            now = time.time()
            if member not in self._members:
                # Expired (or never joined): rejoin.
                self._expire(now)
                self._generation += 1
            self._members[member] = now
            self._expire(now)
            return self._view(member)

    def leave(self, member: str) -> dict:
        with self._lock:
            if self._members.pop(member, None) is not None:
                self._generation += 1
            return {"generation": self._generation}

    def _view(self, member: str) -> dict:
        asg = self._assignment(member)
        return {
            "generation": self._generation,
            "assigned": [[t, p] for t, p in asg],
            "offsets": {f"{t}:{p}": self._offsets.get((t, p), 0)
                        for t, p in asg},
        }

    # -- offsets ----------------------------------------------------------
    def commit(self, member: str, offsets: Dict[str, int]) -> dict:
        with self._lock:
            for key, off in offsets.items():
                t, _, p = key.rpartition(":")
                tp = (t, int(p))
                self._offsets[tp] = max(self._offsets.get(tp, 0),
                                        int(off))
            return {"ok": True}

    def committed(self) -> Dict[str, int]:
        with self._lock:
            return {f"{t}:{p}": off
                    for (t, p), off in self._offsets.items()}

    # -- checkpointing (saveable-resource pattern) -------------------------
    def state(self) -> dict:
        with self._lock:
            return {"offsets": self.committed()}

    def restore_state(self, state: dict):
        with self._lock:
            self._offsets = {}
            for key, off in state.get("offsets", {}).items():
                t, _, p = key.rpartition(":")
                self._offsets[(t, int(p))] = int(off)


class GroupCoordinatorServer:
    """Socket front for :class:`GroupCoordinator` (the WorkQueueServer
    pattern) so workers on other hosts/processes can join."""

    def __init__(self, coord: GroupCoordinator, host: str = "0.0.0.0",
                 port: int = 0):
        c = coord

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = _recv_msg(self.request)
                    except (ConnectionError, OSError):
                        return
                    if msg is None:
                        return
                    op = msg.get("op")
                    if op == "join":
                        _send_msg(self.request, c.join(msg["member"]))
                    elif op == "heartbeat":
                        _send_msg(self.request,
                                  c.heartbeat(msg["member"]))
                    elif op == "leave":
                        _send_msg(self.request, c.leave(msg["member"]))
                    elif op == "commit":
                        _send_msg(self.request, c.commit(
                            msg["member"], msg["offsets"]))
                    else:
                        _send_msg(self.request, {"error": "bad op"})

        self._srv = socketserver.ThreadingTCPServer((host, port),
                                                    Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


class _CoordClient:
    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=30)

    def call(self, **msg) -> dict:
        _send_msg(self._sock, msg)
        out = _recv_msg(self._sock)
        if out is None:
            raise ConnectionError("coordinator closed")
        return out

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaGroupDataset:
    """Group-coordinated streaming consumer: the
    ``KafkaGroupIODataset`` analog.

    Fetches ONLY the partitions the coordinator assigns to this member,
    re-seeks to the group's committed offsets whenever the generation
    changes (worker joined/left/died), and commits consumed offsets
    after every delivered batch.
    """

    def __init__(self, topics: Sequence[str], member_id: str,
                 bootstrap_servers: str, coordinator: Tuple[str, int],
                 batch_size: int, parse: Callable[[list], dict],
                 poll_timeout: float = 0.2,
                 heartbeat_interval: float = 1.0,
                 max_batches: Optional[int] = None):
        self._topics = list(topics)
        self._member = member_id
        self._consumer = kafka_protocol.NativeKafkaConsumer(
            bootstrap_servers, client_id=member_id)
        self._consumer.subscribe(self._topics)
        self._coord = _CoordClient(*coordinator)
        self._batch_size = batch_size
        self._parse = parse
        self._poll_timeout = poll_timeout
        self._hb_interval = heartbeat_interval
        self._max_batches = max_batches
        self._generation = -1
        self._assigned: List[Tuple[str, int]] = []
        self._apply(self._coord.call(op="join", member=self._member))

    @property
    def assigned(self) -> List[Tuple[str, int]]:
        return list(self._assigned)

    def _apply(self, view: dict):
        """Adopt a coordinator view: restrict the consumer's fetch set
        to the assigned partitions at the group's committed offsets."""
        if view["generation"] == self._generation:
            return
        self._generation = view["generation"]
        old = set(self._assigned)
        old_pos = self._consumer.position()
        self._assigned = [tuple(tp) for tp in view["assigned"]]
        offsets = {}
        for k, off in view["offsets"].items():
            t, _, p = k.rpartition(":")
            tp = (t, int(p))
            # Partitions RETAINED across the rebalance keep their local
            # position when it is ahead of the group commit (avoids
            # re-training the current partial batch on every membership
            # change); newly ASSIGNED ones start at the group commit.
            offsets[tp] = (max(int(off), old_pos.get(tp, 0))
                           if tp in old else int(off))
        self._consumer._offsets = dict(offsets)
        self._consumer._positions = dict(offsets)
        # Drop fetched-not-consumed messages: revoked ones are stale,
        # retained ones re-fetch from the kept position (offsets ==
        # positions again, so no record is skipped or duplicated).
        self._consumer._buffer = []

    def _heartbeat(self):
        self._apply(self._coord.call(op="heartbeat",
                                     member=self._member))

    def _commit(self):
        pos = self._consumer.position()
        self._coord.call(op="commit", member=self._member,
                         offsets={f"{t}:{p}": off
                                  for (t, p), off in pos.items()})

    def __iter__(self):
        buf: list = []
        emitted = 0
        idle = 0
        last_hb = 0.0
        while True:
            now = time.time()
            if now - last_hb >= self._hb_interval:
                self._heartbeat()
                last_hb = now
            if not self._assigned:
                time.sleep(self._poll_timeout)
                idle += 1
                if self._max_batches is not None and idle >= 20:
                    return
                continue
            msg = self._consumer.poll(self._poll_timeout)
            if msg is None or msg.error():
                idle += 1
                if self._max_batches is not None and idle >= 3:
                    # Drained: deliver the partial tail batch so a
                    # bounded run trains every record it consumed.
                    if buf:
                        yield self._parse(buf)
                        buf = []
                        self._commit()
                    return
                continue
            idle = 0
            buf.append(msg.value())
            if len(buf) == self._batch_size:
                batch = self._parse(buf)
                buf = []
                yield batch
                self._commit()
                emitted += 1
                if (self._max_batches is not None
                        and emitted >= self._max_batches):
                    return

    def close(self, graceful: bool = True):
        if graceful:
            try:
                self._coord.call(op="leave", member=self._member)
            except (ConnectionError, OSError):
                pass
        self._coord.close()
        self._consumer.close()


def coordinator_for_topics(bootstrap_servers: str,
                           topics: Sequence[str],
                           session_timeout: float = 10.0,
                           port: int = 0):
    """Convenience: discover partitions from the broker and start a
    coordinator server.  Returns (coordinator, server)."""
    host, _, bport = bootstrap_servers.partition(":")
    client = kafka_protocol.KafkaProtocolClient(host, int(bport or 9092),
                                                "coordinator")
    try:
        meta = client.metadata(list(topics))
    finally:
        client.close()
    parts = [(t, p) for t, ps in meta.items() for p in ps]
    coord = GroupCoordinator(parts, session_timeout=session_timeout)
    return coord, GroupCoordinatorServer(coord, port=port)
