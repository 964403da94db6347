"""Serving worker: the process behind the C ABI processor.

``libdeeprec_processor.so`` (``native/processor.cc``) spawns this
module, reads the ``PORT <n>`` line from stdout, then proxies
``process()`` calls to the HTTP scorer it hosts.  The split mirrors the
reference's deliverable (``serving/processor/serving/processor.h:4-12``
— a dlopen-able C entry over a full serving runtime): the native shim
is the stable ABI, this worker is the runtime (model load, full/delta
updates, scoring on the device).

Model entry contract (the ``model_entry`` argument of ``initialize``):
a Python module path or ``.py`` file exposing::

    def build(config: dict) -> dict
        # returns {"group": EmbeddingGroup, "apply_fn": fn,
        #          "ts_template": TrainState,
        #          "parse_request": fn(json) -> batch dict,
        #          "format_response": optional fn(out) -> json dict}

Config JSON (the ``model_config`` argument, forwarded verbatim via the
``DEEPREC_MODEL_CONFIG`` env var) mirrors the reference's processor
config surface (``model_config.h:9-56``): ``checkpoint_dir``,
``update_interval_s`` (ModelStore polling), ``host``/``port``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys


def load_entry(model_entry: str):
    """Import the model-entry module (module path or .py file)."""
    if model_entry.endswith(".py") or os.path.sep in model_entry:
        spec = importlib.util.spec_from_file_location(
            "deeprec_model_entry", model_entry)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(model_entry)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    model_entry = argv[0]
    config = json.loads(os.environ.get("DEEPREC_MODEL_CONFIG", "{}"))

    if config.get("platform"):
        # Must run before any jitted code: pins this worker's backend
        # (e.g. "cpu" when another process already holds the card).
        import jax
        jax.config.update("jax_platforms", str(config["platform"]))

    from deeprec_tpu.serving.processor import (HttpScorer, ModelWatcher,
                                               ServingModel)

    mod = load_entry(model_entry)
    parts = mod.build(config)
    model = ServingModel(parts["group"], parts["apply_fn"],
                         parts["ts_template"],
                         config["checkpoint_dir"])
    model.full_update()
    scorer = HttpScorer(model, parts["parse_request"],
                        parts.get("format_response"),
                        host=config.get("host", "127.0.0.1"),
                        port=int(config.get("port", 0)))
    scorer.start()
    watcher = None
    if config.get("update_interval_s"):
        watcher = ModelWatcher(model,
                               float(config["update_interval_s"]))
        watcher.start()

    print(f"PORT {scorer.port}", flush=True)
    # Serve until the parent closes our stdin (processor deinitialize)
    # or sends EOF — the lifetime contract with the native shim.
    try:
        sys.stdin.read()
    except KeyboardInterrupt:
        pass
    if watcher:
        watcher.stop()
    scorer.stop()


if __name__ == "__main__":
    main()
