"""Fréchet distance between real and generated feature distributions
(torch twin of ``gan_deeplearning4j_tpu/eval/fid.py``).

The standard FID embeds both sets in an InceptionV3 pool3 space,
unavailable offline; as in the JAX package, features come from a
classifier's inference-mode activations (the run's own transfer
classifier at ``dis_dense_layer_6``, or the frozen extractor of
``fid_extractor``), Gaussian moments per set, and

    FID = ||mu_r - mu_g||^2 + Tr(C_r + C_g - 2 (C_r C_g)^(1/2))

in float64 on the host.  ``synthesize_pixels`` draws its latents from
``np.random.RandomState(seed)``, a stream both packages share, so the same
generator params give the same pixels up to the convolutions' rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_FEATURE_LAYER = "dis_dense_layer_6"


def extract_features(graph, x: np.ndarray, layer: str = DEFAULT_FEATURE_LAYER,
                     batch_size: int = 500) -> np.ndarray:
    """Inference-mode activations of ``layer`` over ``x`` [N, ...] -> an f32
    [N, width] host array.  Fixed batches (the last one zero-padded and
    trimmed), so every forward has one shape; one readback at the end."""
    outs = []
    n = x.shape[0]
    with torch.no_grad():
        for i in range(0, n, batch_size):
            xb = np.asarray(x[i:i + batch_size], dtype=np.float32)
            k = xb.shape[0]
            if k < batch_size:
                xb = np.concatenate(
                    [xb, np.zeros((batch_size - k, *xb.shape[1:]), np.float32)])
            values, _ = graph._forward(
                graph.params,
                {graph.input_names[0]: torch.from_numpy(xb).to(graph.device)},
                False)
            outs.append(values[layer][:k])
    # f32 on the host: under --mp the activations are bf16
    return torch.cat(outs).reshape(n, -1).float().cpu().numpy()


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, cov1) and N(mu2, cov2), with
    Tr((C1 C2)^1/2) computed symmetrically as Tr((C1^1/2 C2 C1^1/2)^1/2)
    by two Hermitian eigendecompositions."""
    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh(cov1 + np.eye(cov1.shape[0]) * eps)
    sqrt_c1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt_c1 @ (cov2 + np.eye(cov2.shape[0]) * eps) @ sqrt_c1
    w2 = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sqrt(np.clip(w2, 0.0, None)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * tr_sqrt)


def fid_from_features(feat_real: np.ndarray, feat_gen: np.ndarray) -> float:
    return frechet_distance(feat_real.mean(axis=0),
                            np.cov(feat_real, rowvar=False),
                            feat_gen.mean(axis=0),
                            np.cov(feat_gen, rowvar=False))


def compute_fid(classifier, real: np.ndarray, generated: np.ndarray,
                layer: str = DEFAULT_FEATURE_LAYER,
                batch_size: int = 500) -> float:
    """FID of ``generated`` against ``real`` ([N, num_features] pixels) in
    ``classifier``'s feature space."""
    return fid_from_features(
        extract_features(classifier, real, layer, batch_size),
        extract_features(classifier, generated, layer, batch_size))


def synthesize_pixels(gen, n_samples: int, num_features: int,
                      z_size: int = 2, seed: int = 666,
                      batch_size: int = 500,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """``n_samples`` generator outputs from z ~ U[-1,1]^z (the training
    latent law), flattened to an f32 [n, num_features] host array."""
    rng = rng or np.random.RandomState(seed)
    outs = []
    for i in range(0, n_samples, batch_size):
        k = min(batch_size, n_samples - i)
        z = rng.rand(batch_size, z_size).astype(np.float32) * 2.0 - 1.0
        out = gen.output(torch.from_numpy(z).to(gen.device))[0]
        outs.append(out.reshape(batch_size, num_features)[:k])
    return torch.cat(outs).float().cpu().numpy()

