"""Byzantine attack generators (port of ``repro.data.attacks``).

* :func:`label_flip` — data poisoning of one private train shard (numpy,
  bit-identical to the reference);
* :func:`scaled_update` — model poisoning: the client reports ``scale``
  times its true LoRA upload (tensors).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def label_flip(shard: Dict[str, np.ndarray], seed: int = 0
               ) -> Dict[str, np.ndarray]:
    """Each row's class label moves to a uniformly drawn *different* class
    and the template token region is rewritten to that class's template
    (``loss_mask`` and the modality features keep describing the true
    class).  Returns a new dict; the input is untouched."""
    templates = np.asarray(shard["templates"])
    n_classes, template_len = templates.shape
    labels = np.asarray(shard["label"])
    n = labels.shape[0]
    out = dict(shard)
    if n == 0 or n_classes < 2:
        return out
    rng = np.random.default_rng([seed, 0xFA15E])
    shift = rng.integers(1, n_classes, size=n)
    flipped = ((labels + shift) % n_classes).astype(labels.dtype)
    tokens = np.array(shard["tokens"], copy=True)
    starts = np.asarray(shard["template_start"])
    cols = starts[:, None] + np.arange(template_len)[None, :]
    tokens[np.arange(n)[:, None], cols] = templates[flipped]
    out["tokens"] = tokens
    out["label"] = flipped
    return out


def scaled_update(upload: Dict[str, torch.Tensor], scale: float
                  ) -> Dict[str, torch.Tensor]:
    """Report ``scale × u`` instead of ``u``: the product in f32, rounded
    once to the upload dtype (the reference's op sequence)."""
    s = torch.tensor(scale, dtype=torch.float32)
    return {k: (v.float() * s.to(v.device)).to(v.dtype)
            for k, v in upload.items()}
