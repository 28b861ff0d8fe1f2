"""Predictors and distributed batch inference (counterpart of
``ray_tpu/train/predictor.py``; reference: python/ray/train/predictor.py:38
and python/ray/train/batch_predictor.py:23).

``TorchPredictor`` is the counterpart of ``JaxPredictor``: a module in
eval mode on an explicit device (CUDA unless ``device="cpu"``; where there
is no CUDA it raises), loaded from a checkpoint's state dict, run under
``torch.inference_mode`` on numpy batches.  ``BatchPredictor`` maps a
checkpointed predictor over a Dataset: it puts the checkpoint in the
object store once, and each worker process builds one predictor and
serves every block scheduled there.  Its block tasks ask for a card when
the predictor runs on CUDA, and for none on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """One-model inference over numpy batches."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kw) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """A ``torch.nn.Module`` over numpy batches: inputs from the batch's
    ``input_column`` (default: the single column present), outputs in
    ``output_column`` as numpy (bf16 promoted to fp32)."""

    def __init__(self, model, input_column: Optional[str] = None,
                 output_column: str = "predictions", device=None):
        from ray_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        self._model = model.to(self.device).eval()
        self._in = input_column
        self._out = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        model: Union[Any, Callable[[], Any]],
                        input_column: Optional[str] = None,
                        output_column: str = "predictions",
                        device=None) -> "TorchPredictor":
        """``model`` is the module, or a function that builds it; the
        checkpoint's state dict (``Checkpoint.from_state_dict``) is
        loaded into it, every key required."""
        import torch

        if not isinstance(model, torch.nn.Module):
            model = model()
        model.load_state_dict(checkpoint.to_state_dict(), strict=True)
        return cls(model, input_column, output_column, device)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        col = self._in
        if col is None:
            if len(batch) != 1:
                raise ValueError(
                    f"batch has columns {sorted(batch)}; pass input_column")
            col = next(iter(batch))
        with torch.inference_mode():
            out = self._model(torch.as_tensor(batch[col]).to(self.device))
        out = out.detach().cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return {**batch, self._out: out.numpy()}


class BatchPredictor:
    """Map a checkpointed predictor over a Dataset (reference:
    batch_predictor.py:23).  Each block task asks for a card when the
    predictor's device is CUDA (the default), and for none when it is
    given ``device="cpu"``."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kw):
        self._ckpt = checkpoint
        self._cls = predictor_cls
        self._kw = predictor_kw
        device = predictor_kw.get("device")
        on_cpu = device is not None and str(device).startswith("cpu")
        self._num_gpus = 0 if on_cpu else 1

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls,
                        **predictor_kw) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kw)

    def predict(self, dataset, *, keep_columns=None):
        """A new Dataset with the prediction column appended (lazy, as
        every ``map_batches``).  Each block task builds the predictor in
        its worker the first time and serves every later block there."""
        import uuid

        import ray_tpu_torch

        # Put the checkpoint in the object store once: captured in the
        # closure it would be serialized into every block task.
        ckpt_ref = ray_tpu_torch.put(self._ckpt.to_dict())
        predictor_cls, kw = self._cls, self._kw
        # One token for the whole fan-out: the block tasks of this call
        # share one predictor a worker, keyed by value (the closure
        # deserializes anew for every task).
        token = uuid.uuid4().hex

        def _infer(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            import ray_tpu_torch as rt
            import ray_tpu_torch.train.predictor as mod

            cache = getattr(mod, "_predictor_cache", None)
            if cache is None:
                cache = {}
                mod._predictor_cache = cache
            predictor = cache.get(token)
            if predictor is None:
                cache.clear()  # one live predictor a worker
                predictor = predictor_cls.from_checkpoint(
                    Checkpoint.from_dict(rt.get(ckpt_ref)), **kw)
                cache[token] = predictor
            out = predictor.predict(batch)
            if keep_columns is not None:
                keep = set(keep_columns) | {kw.get("output_column",
                                                   "predictions")}
                out = {k: v for k, v in out.items() if k in keep}
            return out

        return dataset.map_batches(_infer, batch_format="numpy",
                                   num_gpus=self._num_gpus)
