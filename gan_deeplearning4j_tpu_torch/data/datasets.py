"""Datasets of the port: the synthetic MNIST surrogate and the CV
program's CSV contract (own copies of ``synthetic_mnist``,
``export_mnist_csv``, ``ensure_mnist_csv`` and ``load_split`` in
``gan_deeplearning4j_tpu/data/datasets.py``; tests/test_torch_graph.py and
tests/test_torch_data.py pin them byte-equal to those), and the insurance
program's transaction lattices and CSV pair (own copies of
``synthetic_transactions``, ``prepare_insurance`` and
``ensure_insurance_csv``; tests/test_torch_insurance.py pins the files
byte-equal), and the roadmap families' CelebA and CIFAR-10 surrogates (own
copies of ``synthetic_celeba`` and ``synthetic_cifar10``;
tests/test_torch_roadmap.py and tests/test_torch_cgan.py pin them
byte-equal).

The reference's data (a Keras MNIST download) is unavailable offline, so
both packages train on procedural bitmap-font digits with real class
structure, written to ``mnist_{train,test}.csv`` in the notebook's
contract (784 pixels ``%.2f``, the integer label as column 784) and read
back through the CSV iterator.  ``mnist_table`` gives that decoded table
without the files.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.data.codec import U8X100_TABLE
from gan_deeplearning4j_tpu_torch.data.csv import CSVRecordReader

SEED = 666  # numberOfTheBeast — the reference's seed everywhere

# ---------------------------------------------------------------------------
# MNIST (surrogate): procedural 5x7 bitmap-font digits -> 28x28
# ---------------------------------------------------------------------------

_DIGIT_FONT = [
    # 5x7 bitmaps, row-major, one string per digit
    "01110100011001110101110011000101110",  # 0
    "00100011000010000100001000010001110",  # 1
    "01110100010000100010001000100011111",  # 2
    "11111000100010000010000011000101110",  # 3
    "00010001100101010010111110001000010",  # 4
    "11111100001111000001000011000101110",  # 5
    "00110010001000011110100011000101110",  # 6
    "11111000010001000100010000100001000",  # 7
    "01110100011000101110100011000101110",  # 8
    "01110100011000101111000010001001100",  # 9
]


def _digit_bitmap(d: int) -> np.ndarray:
    bits = np.frombuffer(_DIGIT_FONT[d].encode(), dtype=np.uint8) - ord("0")
    return bits.reshape(7, 5).astype(np.float32)


# Symmetric confusable-glyph pairing for the calibrated difficulty tier:
# morphing happens WITHIN these pairs, and symmetry is what creates a
# genuine Bayes floor (a blend of 4-and-9 at mix 0.5 is equally likely to
# have come from either class; an asymmetric pairing would leak the source
# class through the pair identity and the ceiling would silently return
# to 1.0).
_CONFUSABLE = {0: 8, 8: 0, 1: 7, 7: 1, 3: 5, 5: 3, 4: 9, 9: 4, 2: 6, 6: 2}

# difficulty presets: affine pose ranges + the morph mixture.  "v1":
# clean glyphs, mild pose (a classifier saturates on it).  "calibrated":
# harder pose + confusable-pair morphing with mix alpha ~ 95% U(0,.3) +
# 5% U(.3,.7); P(alpha>.5) = 0.025 puts the Bayes accuracy ceiling at
# ~0.975 by construction (those samples are past the class midpoint,
# labeled by source).
_MNIST_DIFFICULTY = {
    "v1": dict(theta=0.26, smin=2.4, smax=3.2, shear=0.15, trans=2.0,
               p_tail=0.0, morph=False),
    "calibrated": dict(theta=0.35, smin=2.2, smax=3.3, shear=0.22,
                       trans=2.5, p_tail=0.05, morph=True),
}


def synthetic_mnist(
    n: int, seed: int = SEED, noise: float = 0.08, chunk: int = 4096,
    difficulty: str = "calibrated",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-like digits: bitmap glyphs pushed through a
    random affine (rotation, anisotropic scale, shear, translation) with
    bilinear sampling, per-sample intensity variation and pixel noise;
    features in [0,1] like the notebook's /255 scaling.

    ``difficulty`` picks the ``_MNIST_DIFFICULTY`` preset: "calibrated"
    (default) adds confusable-pair glyph morphing whose mixture tail sets
    a ~0.975 Bayes accuracy ceiling; "v1" is the separable tier.

    Returns (features[n,784] float32, labels[n] int64).
    """
    cfg = _MNIST_DIFFICULTY[difficulty]
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    glyphs = np.stack([_digit_bitmap(d) for d in range(10)])  # [10, 7, 5]
    partners = np.array([_CONFUSABLE[d] for d in range(10)])
    if cfg["morph"]:
        tail = rng.rand(n) < cfg["p_tail"]
        alpha = np.where(tail, rng.uniform(0.3, 0.7, n),
                         rng.uniform(0.0, 0.3, n)).astype(np.float32)
    else:
        alpha = np.zeros(n, dtype=np.float32)
    out = np.empty((n, 784), dtype=np.float32)
    # output pixel grid, centered
    yy, xx = np.meshgrid(np.arange(28, dtype=np.float32),
                         np.arange(28, dtype=np.float32), indexing="ij")
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        lab = labels[lo:hi]
        al = alpha[lo:hi, None, None]
        # per-sample affine params (inverse map: output px -> glyph coords)
        theta = rng.uniform(-cfg["theta"], cfg["theta"], m).astype(np.float32)
        sx = rng.uniform(cfg["smin"], cfg["smax"], m).astype(np.float32)
        sy = rng.uniform(cfg["smin"], cfg["smax"], m).astype(np.float32)
        shear = rng.uniform(-cfg["shear"], cfg["shear"], m).astype(np.float32)
        tx = rng.uniform(-cfg["trans"], cfg["trans"], m).astype(np.float32)
        ty = rng.uniform(-cfg["trans"], cfg["trans"], m).astype(np.float32)
        cos, sin = np.cos(theta), np.sin(theta)
        # centered output coords [m, 28, 28]
        xo = xx[None] - 13.5 - tx[:, None, None]
        yo = yy[None] - 13.5 - ty[:, None, None]
        # inverse rotation then inverse shear then inverse scale
        xr = cos[:, None, None] * xo + sin[:, None, None] * yo
        yr = -sin[:, None, None] * xo + cos[:, None, None] * yo
        xr = xr - shear[:, None, None] * yr
        gx = xr / sx[:, None, None] + 2.0   # glyph is 5 wide (center 2)
        gy = yr / sy[:, None, None] + 3.0   # glyph is 7 tall (center 3)
        # bilinear sample with zero outside
        x0 = np.floor(gx).astype(np.int32)
        y0 = np.floor(gy).astype(np.int32)
        fx, fy = gx - x0, gy - y0
        # the morph blend commutes with the (linear) bilinear sampling, so
        # the rendered image is exactly (1-a)*render(c) + a*render(partner)
        # at the SAME pose — a true pixel-space class interpolation
        g = (1.0 - al) * glyphs[lab] + al * glyphs[partners[lab]]
        gpad = np.pad(g, ((0, 0), (1, 1), (1, 1)))  # zero border
        x0c = np.clip(x0 + 1, 0, 5 + 1)
        y0c = np.clip(y0 + 1, 0, 7 + 1)
        x1c = np.clip(x0 + 2, 0, 5 + 1)
        y1c = np.clip(y0 + 2, 0, 7 + 1)
        idx = np.arange(m)[:, None, None]
        img = ((1 - fx) * (1 - fy) * gpad[idx, y0c, x0c]
               + fx * (1 - fy) * gpad[idx, y0c, x1c]
               + (1 - fx) * fy * gpad[idx, y1c, x0c]
               + fx * fy * gpad[idx, y1c, x1c])
        img *= rng.uniform(0.7, 1.0, m)[:, None, None]        # intensity
        img += rng.randn(m, 28, 28).astype(np.float32) * noise
        np.clip(img, 0.0, 1.0, out=img)
        out[lo:hi] = img.reshape(m, 784).astype(np.float32)
    return out, labels.astype(np.int64)


def export_mnist_csv(out_dir: str, n_train: int = 60000, n_test: int = 10000,
                     seed: int = SEED) -> Tuple[str, str]:
    """Write ``mnist_{train,test}.csv`` in the notebook's contract (cell 2):
    784 feature columns formatted %.2f, integer label as column 784."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for split, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        path = os.path.join(out_dir, f"mnist_{split}.csv")
        feats, labels = synthetic_mnist(n, seed=s)
        table = np.concatenate(
            [feats, labels.reshape(-1, 1).astype(np.float32)], axis=1)
        np.savetxt(path, table, delimiter=",", fmt=["%.2f"] * 784 + ["%d"])
        paths.append(path)
    return tuple(paths)


def ensure_mnist_csv(data_dir: str, n_train: int = 60000,
                     n_test: int = 10000) -> Tuple[str, str]:
    """Return (train_csv, test_csv), generating the synthetic surrogate only
    if the contract files don't already exist (real exported MNIST wins;
    a half-present pair is an error rather than a silent overwrite)."""
    train = os.path.join(data_dir, "mnist_train.csv")
    test = os.path.join(data_dir, "mnist_test.csv")
    have = (os.path.exists(train), os.path.exists(test))
    if have == (True, True):
        return train, test
    if have != (False, False):
        raise FileExistsError(
            f"one of {train} / {test} exists without the other; refusing to "
            "overwrite — delete the stray file or provide both")
    export_mnist_csv(data_dir, n_train, n_test)
    return train, test


# ---------------------------------------------------------------------------
# Insurance: synthetic transaction lattices (notebook cell 8 pipeline)
# ---------------------------------------------------------------------------

N_POLICIES = 1000
N_PERIODS = 4       # tensorDimOneSize (dl4jGANInsurance.java:70)
N_TYPES = 3         # tensorDimTwoSize (:71)


def synthetic_transactions(
    n_policies: int = N_POLICIES, seed: int = SEED,
    difficulty: str = "calibrated",
) -> Tuple[np.ndarray, np.ndarray]:
    """Label-dependent transaction lattices: (transactions[n, 4, 3],
    risk[n]), standing in for the reference's R-generated
    ``data/transactions.csv`` + ``data/claim_risk.csv``.  High-risk policies
    (P = 0.3) escalate claim-type activity across the periods; low-risk
    ones keep flat premium-type activity.

    ``"calibrated"`` (the default) makes the risk signal heterogeneous so
    that the AUROC cannot saturate: each risky policy's escalation is scaled
    by a Gamma(2) random effect and 8% of benign policies get claim bursts.
    ``"v1"`` is the cleanly separable tier."""
    rng = np.random.RandomState(seed)
    risk = (rng.rand(n_policies) < 0.3).astype(np.int64)
    base = np.array([[6.0, 3.0, 0.5]] * N_PERIODS)  # premium, service, claim
    lam = np.tile(base, (n_policies, 1, 1))
    escalate = np.array([0.5, 1.0, 2.0, 4.0]).reshape(1, N_PERIODS)
    if difficulty == "calibrated":
        gamma = rng.gamma(2.0, 0.5, n_policies)     # mean-1 random effect
        eff = risk * gamma
        burst = (risk == 0) & (rng.rand(n_policies) < 0.08)
        eff = eff + burst * rng.uniform(0.4, 1.0, n_policies)
        lam[:, :, 2] += eff.reshape(-1, 1) * escalate * 1.5
        lam[:, :, 0] -= eff.reshape(-1, 1) * escalate * 0.5
    elif difficulty == "v1":
        lam[:, :, 2] += risk.reshape(-1, 1) * escalate * 2.0
        lam[:, :, 0] -= risk.reshape(-1, 1) * escalate * 0.8
    else:
        raise KeyError(difficulty)
    lam = np.clip(lam, 0.1, None)
    trans = rng.poisson(lam).astype(np.float64)
    return trans, risk


def prepare_insurance(out_dir: str, n_policies: int = N_POLICIES,
                      test_fraction: float = 0.3,
                      seed: int = SEED) -> Tuple[str, str]:
    """The notebook's cell-8 pipeline: reshape to (n, 12), a 70/30 split
    by a seeded permutation, min-max scaling by the train split's
    statistics, and ``insurance_{train,test}.csv`` (12 features ``%.6f``,
    the label as column 12)."""
    os.makedirs(out_dir, exist_ok=True)
    trans, risk = synthetic_transactions(n_policies, seed)
    flat = trans.reshape(n_policies, N_PERIODS * N_TYPES)

    # train_test_split(..., test_size=0.3, random_state=666) semantics
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_policies)
    n_test = int(round(n_policies * test_fraction))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    x_train, x_test = flat[train_idx], flat[test_idx]
    y_train, y_test = risk[train_idx], risk[test_idx]

    lo = x_train.min(axis=0)
    hi = x_train.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    x_train = (x_train - lo) / span
    x_test = (x_test - lo) / span  # train stats, per the notebook

    paths = []
    for split, x, y in (("train", x_train, y_train), ("test", x_test, y_test)):
        path = os.path.join(out_dir, f"insurance_{split}.csv")
        table = np.concatenate([x, y.reshape(-1, 1).astype(np.float64)], axis=1)
        np.savetxt(path, table, delimiter=",", fmt="%.6f")
        paths.append(path)
    return tuple(paths)


def ensure_insurance_csv(data_dir: str) -> Tuple[str, str]:
    """Return (train_csv, test_csv), writing them only when neither
    exists; a half-present pair is an error, not an overwrite."""
    train = os.path.join(data_dir, "insurance_train.csv")
    test = os.path.join(data_dir, "insurance_test.csv")
    have = (os.path.exists(train), os.path.exists(test))
    if have == (True, True):
        return train, test
    if have != (False, False):
        raise FileExistsError(
            f"one of {train} / {test} exists without the other; refusing to "
            "overwrite — delete the stray file or provide both")
    prepare_insurance(data_dir)
    return train, test


def load_split(path: str, label_index: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a contract CSV into (features, raw label column)."""
    table = CSVRecordReader().read(path)
    return np.delete(table, label_index, axis=1), table[:, label_index]


def contract_pixels(features: np.ndarray) -> np.ndarray:
    """The f32 values the CSV contract's ``%.2f`` text of ``features``
    decodes to.  For f32 x in [0, 2.55], x*100 is exact in f64 and ``%.2f``
    rounds it to an integer n, ties to even, as ``np.rint`` does; the text
    n/100 parses to the correctly rounded f32 of n/100, the codec table's
    entry n."""
    f = np.asarray(features, dtype=np.float32)
    n = np.rint(f.astype(np.float64) * 100.0)
    if f.size and not (n.min() >= 0 and n.max() <= 255):
        raise ValueError("contract_pixels takes values in [0, 2.55]")
    return U8X100_TABLE[n.astype(np.intp)]


def mnist_table(n: int, seed: int = SEED) -> np.ndarray:
    """The decoded ``mnist_train.csv`` of ``export_mnist_csv(n_train=n)``
    (train split, ``seed``) as an f32 [n, 785] table, without the file:
    the contract's pixels and the label column."""
    feats, labels = synthetic_mnist(n, seed=seed)
    return np.concatenate([contract_pixels(feats),
                           labels.reshape(-1, 1).astype(np.float32)], axis=1)


# ---------------------------------------------------------------------------
# CIFAR-10 (surrogate): class glyphs in class hues for the conditional GAN
# ---------------------------------------------------------------------------

def synthetic_cifar10(
    n: int, seed: int = SEED, size: int = 32,
    difficulty: str = "v1",
) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 surrogate: 10 classes = glyph shape in a class hue over a
    random background tint, random affine pose.  Returns
    (features[n, 3*size*size] float32 in [-1, 1] NCHW-flattened,
    labels[n] int64).

    ``difficulty``: "v1" (crisp class identity) or "calibrated": an 18%
    tail of samples carries label-preserving ambiguity (the glyph faded to
    3-35% contrast, extra pixel noise, the hue moved to the boundary with a
    random neighbour class), so a probe classifier's Bayes ceiling sits
    below 1.0.  The tail draws come from their own stream,
    ``RandomState(seed + 9001)``: non-tail pixels are bit-identical across
    the two tiers."""
    if difficulty not in ("v1", "calibrated"):
        raise ValueError(f"unknown difficulty {difficulty!r}")
    rng = np.random.RandomState(seed)
    gray, labels = synthetic_mnist(n, seed=seed + 1, noise=0.04,
                                   difficulty="v1")
    gray = gray.reshape(n, 28, 28)
    hues = np.linspace(0.0, 1.0, 10, endpoint=False)
    out = np.empty((n, 3, size, size), dtype=np.float32)
    pad = (size - 28) // 2
    rng_tail = (np.random.RandomState(seed + 9001)
                if difficulty == "calibrated" else None)

    def hue_rgb(h):
        phase = h[:, None, None]
        return np.stack([
            0.5 + 0.5 * np.cos(2 * np.pi * (phase + off))
            for off in (0.0, 1 / 3, 2 / 3)], axis=1).astype(np.float32)

    for lo in range(0, n, 4096):
        hi = min(lo + 4096, n)
        m = hi - lo
        g = np.zeros((m, size, size), dtype=np.float32)
        g[:, pad:pad + 28, pad:pad + 28] = gray[lo:hi]
        h = hues[labels[lo:hi]] + rng.uniform(-0.03, 0.03, m)
        rgb = hue_rgb(h)
        bg = rng.uniform(-0.25, 0.25, (m, 3, 1, 1)).astype(np.float32)
        img = bg + g[:, None] * (2.0 * rgb - 1.0 - bg)
        if rng_tail is not None:
            tail = rng_tail.rand(m) < 0.18
            nb = rng_tail.choice([-1.0, 1.0], m)
            h2 = (hues[labels[lo:hi]] + nb * 0.05
                  + rng_tail.uniform(-0.008, 0.008, m))
            fade = rng_tail.uniform(0.03, 0.35, m).astype(np.float32)
            noise = rng_tail.randn(m, 3, size, size).astype(np.float32)
            rgb2 = hue_rgb(h2)
            g2 = g * fade[:, None, None]
            img2 = (bg + g2[:, None] * (2.0 * rgb2 - 1.0 - bg)
                    + 0.12 * noise)
            img[tail] = img2[tail]
        out[lo:hi] = np.clip(img, -1.0, 1.0)
    return out.reshape(n, -1), labels


# ---------------------------------------------------------------------------
# CelebA (surrogate): procedural 64x64 faces for the roadmap DCGAN
# ---------------------------------------------------------------------------

# CelebA-style binary attribute names for the surrogate (real CelebA is a
# 40-binary-attribute dataset; these 8 are the ones the procedural
# generator controls).  Thresholds split each ~50/50 over the draw laws.
CELEBA_ATTR_NAMES = (
    "face_right", "face_low", "big_face", "pale_skin",
    "bright_bg", "dark_hair", "wide_mouth", "tall_face",
)


def synthetic_celeba(n: int, seed: int = SEED, size: int = 64,
                     return_attrs: bool = False):
    """CelebA surrogate: procedural 64x64 'faces' — skin-toned ellipse,
    two eyes, mouth, hair band, varying pose/colors/background.  Returns
    [n, 3*size*size] float32 in [-1, 1], NCHW-flattened; with
    ``return_attrs`` also [n, 8] float32 binary attributes (the analog of
    CelebA's attribute labels, ``CELEBA_ATTR_NAMES``) derived from the
    SAME procedural draws — the pixel stream is bit-identical either way.
    The DCGAN itself is unconditional; the attributes exist to train the
    frozen 64x64 FID feature extractor (eval/fid_extractor.py)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    out = np.empty((n, 3, size, size), dtype=np.float32)
    attrs = np.empty((n, len(CELEBA_ATTR_NAMES)), dtype=np.float32)
    for i in range(n):
        cx, cy = rng.uniform(-0.15, 0.15, 2)
        rx = rng.uniform(0.45, 0.6)
        ry = rng.uniform(0.55, 0.75)
        face = (((xx - cx) / rx) ** 2 + (((yy - cy) / ry) ** 2)) < 1.0
        skin_scale = rng.uniform(0.7, 1.1)
        skin = np.array([0.9, 0.65, 0.5]) * skin_scale
        bg = rng.uniform(-1.0, 1.0, 3)
        img = np.empty((3, size, size), dtype=np.float32)
        for c in range(3):
            img[c] = np.where(face, 2 * skin[c] - 1, bg[c])
        # hair: top band of the face ellipse
        hair_color = rng.uniform(-1.0, 0.0, 3)
        hair = face & (yy < cy - 0.25 * ry)
        for c in range(3):
            img[c] = np.where(hair, hair_color[c], img[c])
        # eyes and mouth
        for ex in (-0.22, 0.22):
            eye = (((xx - cx - ex) / 0.07) ** 2
                   + ((yy - cy + 0.12) / 0.05) ** 2) < 1.0
            img[:, eye] = -0.9
        mouth_rx = rng.uniform(0.12, 0.25)
        mouth = (((xx - cx) / mouth_rx) ** 2
                 + (((yy - cy - 0.35) / 0.05) ** 2)) < 1.0
        img[0, mouth] = 0.6
        img[1:, mouth] = -0.6
        img += rng.randn(3, size, size).astype(np.float32) * 0.04
        out[i] = np.clip(img, -1.0, 1.0)
        attrs[i] = (cx > 0.0, cy > 0.0, rx * ry > 0.34,
                    skin_scale > 0.9, bg.mean() > 0.0,
                    hair_color.mean() < -0.5, mouth_rx > 0.185, ry > 0.65)
    if return_attrs:
        return out.reshape(n, -1), attrs
    return out.reshape(n, -1)
