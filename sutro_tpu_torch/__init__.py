"""PyTorch + CUDA port of the sutro batch-inference engine, for NVIDIA
Hopper GPUs (H100).

A package of its own beside the JAX package ``sutro_tpu``, which stays
the reference: the layout and names mirror it (``models/``, ``ops/``,
``engine/``, ``telemetry/``), and nothing here imports JAX or the JAX
package. Every Pallas kernel on the engine's path is a hand-written
CUDA kernel under ``csrc/`` (built with ``nvcc`` at first use) with a
plain PyTorch version beside it in ``ops/``; a wrapper launches its
kernel on a CUDA tensor and runs the plain version on a CPU tensor.

Module façade, as the JAX package's: a ``Sutro()`` singleton is made at
import time and its public bound methods are hoisted to module scope,
so ``import sutro_tpu_torch as so; so.infer(...)``,
``so.classify(...)``, ``so.embed(...)``, ``so.score`` / ``so.rank``,
the function calls and the dataset methods (``so.create_dataset``,
``so.upload_to_dataset``, then ``so.infer("dataset-<id>", column=...)``)
submit jobs to the in-process ``LocalEngine``
(``engine/api.py``): jobstore, worker thread, co-batched
``ContinuousBatcher`` sessions over a ``ModelRunner`` on the card, with
weights from ``EngineConfig.weights_dir`` (``engine/weights.py``
``load_checkpoint``) or random ones from the seed. Only methods are
hoisted — properties (``Sutro.engine``) are skipped, so importing the
package builds no engine and touches no state directory; the engine
starts on the first job. The engine runs on the GPU unless built with
``device="cpu"`` (``engine.api.get_engine(ecfg, device="cpu")`` before
the first job, as the tests do).
"""

from .sdk import Sutro

_instance = Sutro()

__all__ = ["Sutro"]
for _name in dir(_instance):
    if _name.startswith("_"):
        continue
    if isinstance(getattr(type(_instance), _name, None), property):
        continue
    _attr = getattr(_instance, _name)
    if callable(_attr):
        globals()[_name] = _attr
        __all__.append(_name)

__version__ = "0.1.0"
