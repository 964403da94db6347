"""Host-side staged prefetch — the ``tf.staged`` / SmartStage role.

The reference hides input latency by carving the IO subgraph out of the
training graph and running it in background threads through
TensorBuffer queues (``python/ops/prefetch.py:55``,
``core/kernels/tensor_buffer_ops.cc``, ``docs/Smart-Stage.md``).  Here
the equivalent split is host/device: batch assembly (parse, pad,
id-split) runs in Python threads ahead of time, and completed batches
are transferred so the device never waits on the host.

``PrefetchIterator`` = Stage (explicit staging of one iterator, N
worker threads, bounded buffer).  ``device_put_sharded_batches`` plays
the TensorBufferPut role of landing data on device ahead of use.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import jax


class PrefetchIterator:
    """Wrap a batch iterator with background worker threads.

    num_threads > 1 requires ``make_iter`` to be safe to call per
    thread (each worker gets its own iterator, like the reference's N
    stage runners); with 1 thread any iterator works.
    """

    def __init__(self, make_iter: Callable[[], Iterator[Any]],
                 buffer_size: int = 4, num_threads: int = 1,
                 transform: Optional[Callable[[Any], Any]] = None,
                 device_put: bool = True):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._transform = transform
        self._device_put = device_put
        self._threads = []
        self._exhausted = threading.Semaphore(0)
        self._num_threads = num_threads
        for _ in range(num_threads):
            t = threading.Thread(target=self._worker, args=(make_iter,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, make_iter):
        try:
            for item in make_iter():
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if self._device_put:
                    item = jax.device_put(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            self._exhausted.release()

    def __iter__(self):
        return self

    def __next__(self):
        done = 0
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._exhausted.acquire(blocking=False):
                    done += 1
                    self._exhausted.release()
                if done and self._q.empty() and all(
                        not t.is_alive() for t in self._threads):
                    raise StopIteration
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


def staged(iterator_factory, buffer_size: int = 4, num_threads: int = 1,
           transform=None, device_put: bool = True) -> PrefetchIterator:
    """``tf.staged`` analog: stage an input pipeline behind the step."""
    return PrefetchIterator(iterator_factory, buffer_size=buffer_size,
                            num_threads=num_threads, transform=transform,
                            device_put=device_put)
