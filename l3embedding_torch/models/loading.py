"""Model and embedding loading, the reference's ``load_model`` /
``load_embedding`` surface (port of ``l3embedding_tpu/models/loading.py``,
reference l3embedding/model.py:85-181).

``src_num_gpus`` / ``tgt_num_gpus`` / ``return_io`` are accepted for
signature compatibility and ignored. Weights are the JAX package's
``.ckpt`` files or reference Keras ``.h5`` weight files (read through
``compat/keras_import.py``, which unwraps multi-GPU-wrapped files; h5py
is needed only for them).
"""

from __future__ import annotations

import torch

from ..compat.from_jax import avc_from_jax_variables
from ..embed.extract import INIT_SEED
from ..training.checkpoints import load_variables
from .embedding import audio_embedding_fn, vision_embedding_fn
from .registry import build_model


def load_model(weights_path, model_type, src_num_gpus=0, tgt_num_gpus=None,
               return_io=False, *, device: str | torch.device = "cuda"):
    """→ (model, state_dict): the f32 AVCModel in eval mode on `device`,
    with the weights of a ``.ckpt`` (the full AVC tree) or of a reference
    Keras ``.h5``, or He-normal ones from a generator seeded with
    INIT_SEED when weights_path is empty."""
    model = build_model(model_type).module()
    if weights_path and str(weights_path).endswith(".h5"):
        from ..compat.keras_import import import_avc_weights

        model.load_state_dict(avc_from_jax_variables(import_avc_weights(weights_path, model_type), model_type))
    elif weights_path:
        model.load_state_dict(avc_from_jax_variables(load_variables(weights_path), model_type))
    else:
        model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    model = model.eval().to(device)
    return model, model.state_dict()


def load_embedding(weights_path, model_type, embedding_type, pooling_type,
                   src_num_gpus=0, tgt_num_gpus=None, return_io=False,
                   db_batch_global=False, *, device: str | torch.device = "cuda"):
    """→ callable(batch) → (B, dim) embeddings as a tensor on `device`, the
    reference's truncated-model semantics (model.py:131-181): audio batches
    (B, 1, 48000) or (B, 48000) PCM, vision batches (B, 224, 224, 3) in
    [-1, 1], as tensors or arrays. db_batch_global reproduces kapre<=0.1.x's
    batch-global dB quirk."""
    model, _ = load_model(weights_path, model_type, device=device)
    if embedding_type == "audio":
        fn = audio_embedding_fn(model_type, pooling_type, db_batch_global=db_batch_global)
        fn.tower.load_state_dict(model.audio_model.state_dict())
    elif embedding_type == "vision":
        fn = vision_embedding_fn(model_type)
        fn.tower.load_state_dict(model.vision_model.state_dict())
    else:
        raise ValueError(f'Invalid embedding type: "{embedding_type}"')
    fn = fn.eval().to(device)

    def embed(batch):
        return fn(torch.as_tensor(batch, dtype=torch.float32, device=device))

    embed.model = fn
    embed.model_type = model_type
    return embed
