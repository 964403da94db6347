"""KServe v2 / Open Inference Protocol front end (the Triton shim role).

The reference ships a Triton backend adapter
(``triton/tensorflow_backend_tf.cc``) so Triton can serve its models.
Triton's client-facing contract is the KServe "v2" Open Inference
Protocol; the equivalent here is to speak that protocol directly
over the serving runtime, so any Triton/KServe HTTP client works
against ``ServingModel`` unchanged:

  GET  /v2                         server metadata
  GET  /v2/health/live|ready       liveness / readiness
  GET  /v2/models/{m}              model metadata (declared tensors)
  GET  /v2/models/{m}/ready        model readiness (a version loaded)
  POST /v2/models/{m}/infer        inference (v2 tensor payloads)

Tensor mapping to the framework batch dict is declared with
``TensorSpec`` (the model-config role of Triton's config.pbtxt):
'numeric' -> FP32 arrays, 'id' -> INT64 [B, L] -> ``SparseIds``,
'id_str' -> BYTES hashed with the framework hash (the
categorical_column_with_hash_bucket behavior).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import numpy as np

from deeprec_tpu.feature_column.feature_column import SparseIds
from deeprec_tpu.serving.processor import ServingModel

_PROTOCOL_DTYPES = {"numeric": "FP32", "id": "INT64", "id_str": "BYTES"}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declared shape/kind of one request input tensor.

    kind: 'numeric' (FP32, [B] or [B, k]), 'id' (INT64 [B, L] ->
    SparseIds), 'id_str' (BYTES [B] -> 64-bit hash -> SparseIds [B, 1]).
    ``dims`` is the per-row shape (without the batch dim) for metadata.
    """

    name: str
    kind: str = "numeric"
    dims: Sequence[int] = ()
    key_offset: int = 0

    @property
    def datatype(self) -> str:
        return _PROTOCOL_DTYPES[self.kind]


def _decode_input(spec: TensorSpec, entry: Dict[str, Any]):
    shape = entry.get("shape") or [len(entry["data"])]
    data = entry["data"]
    if spec.kind == "numeric":
        return np.asarray(data, np.float32).reshape(shape)
    if spec.kind == "id":
        arr = np.asarray(data, np.int64).reshape(shape)
        if arr.ndim == 1:
            arr = arr[:, None]
        return SparseIds.from_numpy(arr + spec.key_offset)
    if spec.kind == "id_str":
        from deeprec_tpu import native
        toks = ["" if v is None else str(v) for v in data]
        ids = native.hash_bytes(toks)[:, None] + spec.key_offset
        return SparseIds.from_numpy(ids)
    raise ValueError(f"unknown tensor kind {spec.kind!r}")


class KServeFrontend:
    """HTTP server speaking the Open Inference Protocol over a
    ``ServingModel``. Thread-per-request; ``predict`` is thread-safe."""

    def __init__(self, model: ServingModel, model_name: str,
                 inputs: Sequence[TensorSpec],
                 output_name: str = "score",
                 format_output: Optional[Callable] = None,
                 host: str = "0.0.0.0", port: int = 0):
        self._model = model
        self._name = model_name
        self._inputs = {s.name: s for s in inputs}
        self._output_name = output_name
        self._fmt = format_output or (lambda out: (1.0 / (1.0 + np.exp(
            -np.asarray(jax.device_get(out), np.float64)))))
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, obj) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/v2":
                    self._send(200, front.server_metadata())
                elif path in ("/v2/health/live", "/v2/health/ready"):
                    self._send(200, {})
                elif path == f"/v2/models/{front._name}":
                    self._send(200, front.model_metadata())
                elif path == f"/v2/models/{front._name}/ready":
                    ready = front._model.version is not None
                    self._send(200 if ready else 503, {})
                else:
                    self._send(404, {"error": f"unknown path {path}"})

            def do_POST(self):
                if self.path.rstrip("/") != f"/v2/models/{front._name}/infer":
                    self._send(404, {"error": "unknown model or path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    self._send(200, front.infer(req))
                except Exception as e:
                    self._send(400, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # ---------------------------------------------------------- protocol

    def server_metadata(self) -> Dict[str, Any]:
        return {"name": "deeprec-tpu-serving", "version": "2",
                "extensions": []}

    def model_metadata(self) -> Dict[str, Any]:
        v = self._model.version
        return {
            "name": self._name,
            "versions": [str(v)] if v is not None else [],
            "platform": "deeprec_tpu",
            "inputs": [{"name": s.name, "datatype": s.datatype,
                        "shape": [-1, *s.dims]}
                       for s in self._inputs.values()],
            "outputs": [{"name": self._output_name, "datatype": "FP32",
                         "shape": [-1]}],
        }

    def infer(self, req: Dict[str, Any]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        sizes = set()
        for entry in req.get("inputs", []):
            spec = self._inputs.get(entry.get("name"))
            if spec is None:
                raise ValueError(f"undeclared input {entry.get('name')!r}")
            val = _decode_input(spec, entry)
            shp = val.hi.shape if isinstance(val, SparseIds) else val.shape
            sizes.add(int(shp[0]))
            batch[spec.name] = val
        missing = set(self._inputs) - set(batch)
        if missing:
            raise ValueError(f"missing inputs {sorted(missing)}")
        if len(sizes) != 1:
            raise ValueError(f"inconsistent batch sizes {sorted(sizes)}")
        scores = np.asarray(self._fmt(self._model.predict(batch)),
                            np.float64).reshape(-1)
        return {
            "model_name": self._name,
            "model_version": str(self._model.version),
            "id": req.get("id", ""),
            "outputs": [{"name": self._output_name, "datatype": "FP32",
                         "shape": [scores.size],
                         "data": [float(x) for x in scores]}],
        }

    # ---------------------------------------------------------- lifecycle

    def start(self):
        self._thread.start()

    def stop(self):
        self._server.shutdown()
