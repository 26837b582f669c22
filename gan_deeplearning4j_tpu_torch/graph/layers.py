"""Layer configurations of the named-layer graph (torch twin of
``gan_deeplearning4j_tpu/graph/layers.py``: the layers the DCGAN protocol
uses; ``ConvTranspose2D`` and ``MinibatchStdDev`` of the roadmap families;
and the multi-input vertices of the conditional family, ``Merge``,
``ElementWise``, ``ConditionalBatchNorm`` and ``ProjectionOutput``).

Each config is a dataclass with three methods:
  out_shape(in_shape)      -- shape inference, batch dim excluded (FF
                              shapes (n,), CNN shapes (c, h, w)), with
                              DL4J's Truncate conv arithmetic
  init(gen, in_shape)      -- {param name: CPU tensor}, DL4J names (W, b,
                              gamma, beta, mean, var) and layouts (dense W
                              [n_in, n_out], conv W OIHW)
  apply(params, x, train, gen, group) -- forward; returns
                              (y, state_updates|None); ``group`` is the
                              data-parallel group (sync-BN) or None
A ``multi_input`` layer gets the list of its input shapes and the list of
its input values, in the order the builder named its inputs.

An ``activation``/``updater`` of None inherits the graph default; the BN
layer applies its activation after normalizing, as DL4J does.  A Dense,
Output, Conv2D or ConvTranspose2D layer's ``bf16_matmul`` of None follows
the precision policy (``backend.configure(matmul_bf16=...)``); True/False
pins that layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops import (
    activations as act_lib,
    batch_norm_inference,
    batch_norm_inference_cond,
    batch_norm_train,
    batch_norm_train_cond,
    conv2d,
    conv2d_out_size,
    conv_transpose2d,
    initializers,
    max_pool2d,
    upsample2d,
)
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import fused_bn_act_train
from gan_deeplearning4j_tpu_torch.ops.dense import dense as dense_op, dropout as dropout_op
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.runtime import backend

Shape = Tuple[int, ...]
Params = Dict[str, torch.Tensor]


def _mxu_bf16(layer_flag: Optional[bool]) -> bool:
    """A layer's bf16-matmul setting: its own flag when set, else the
    policy's ``matmul_bf16``."""
    if layer_flag is not None:
        return layer_flag
    return backend.config().matmul_bf16


def _as_ff(x: torch.Tensor) -> torch.Tensor:
    """Auto CnnToFeedForward: flatten trailing dims."""
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


@dataclasses.dataclass
class Layer:
    activation: Optional[str] = None
    updater: Optional[RmsProp] = None
    weight_init: str = "xavier"

    @property
    def has_params(self) -> bool:
        return True

    @property
    def multi_input(self) -> bool:
        """Vertices that take a list of inputs."""
        return False

    def resolved(self, default_activation: str, default_updater: Optional[RmsProp]):
        new = dataclasses.replace(self)
        if new.activation is None:
            new.activation = default_activation
        if new.updater is None:
            new.updater = default_updater
        return new

    def _act(self, x):
        return act_lib.get(self.activation or "identity")(x)

    def out_shape(self, in_shape: Shape) -> Shape:
        raise NotImplementedError

    def init(self, gen: torch.Generator, in_shape: Shape) -> Params:
        return {}

    def apply(self, params: Params, x, train: bool, gen, group=None):
        raise NotImplementedError


@dataclasses.dataclass
class Dense(Layer):
    """DL4J DenseLayer.  W: [n_in, n_out]."""

    n_out: int = 0
    n_in: Optional[int] = None
    bf16_matmul: Optional[bool] = None  # None = the policy

    def out_shape(self, in_shape):
        return (self.n_out,)

    def init(self, gen, in_shape):
        n_in = self.n_in if self.n_in is not None else math.prod(in_shape)
        init = (initializers.xavier if self.weight_init == "xavier"
                else initializers.xavier_uniform)
        w = init(gen, (n_in, self.n_out), n_in, self.n_out)
        return {"W": w, "b": initializers.zeros((self.n_out,))}

    def apply(self, params, x, train, gen, group=None):
        return self._act(dense_op(_as_ff(x), params["W"], params["b"],
                                  bf16=_mxu_bf16(self.bf16_matmul))), None


@dataclasses.dataclass
class Output(Dense):
    """DL4J OutputLayer: a dense layer with a loss attached."""

    loss: str = "xent"


@dataclasses.dataclass
class Conv2D(Layer):
    """DL4J ConvolutionLayer, Truncate mode.  W: [n_out, n_in, kh, kw] (OIHW)."""

    kernel: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    n_in: Optional[int] = None
    n_out: int = 0
    bf16_matmul: Optional[bool] = None  # None = the policy

    def out_shape(self, in_shape):
        _, h, w = in_shape
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.padding
        return (self.n_out, conv2d_out_size(h, kh, sh, ph),
                conv2d_out_size(w, kw, sw, pw))

    def init(self, gen, in_shape):
        n_in = self.n_in if self.n_in is not None else in_shape[0]
        kh, kw = self.kernel
        fan_in, fan_out = initializers.fan_in_out_conv(n_in, self.n_out, (kh, kw))
        w = initializers.xavier(gen, (self.n_out, n_in, kh, kw), fan_in, fan_out)
        return {"W": w, "b": initializers.zeros((self.n_out,))}

    def apply(self, params, x, train, gen, group=None):
        y = conv2d(x, params["W"], params["b"], self.stride, self.padding,
                   bf16=_mxu_bf16(self.bf16_matmul))
        return self._act(y), None


@dataclasses.dataclass
class ConvTranspose2D(Layer):
    """Transposed conv of the roadmap DCGANs.  W: [n_out, n_in, kh, kw]
    (the JAX package's layout and Xavier fans)."""

    kernel: Sequence[int] = (4, 4)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (1, 1)
    n_in: Optional[int] = None
    n_out: int = 0
    bf16_matmul: Optional[bool] = None  # None = the policy

    def out_shape(self, in_shape):
        _, h, w = in_shape
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.padding
        return (self.n_out, (h - 1) * sh - 2 * ph + kh,
                (w - 1) * sw - 2 * pw + kw)

    def init(self, gen, in_shape):
        n_in = self.n_in if self.n_in is not None else in_shape[0]
        kh, kw = self.kernel
        fan_in, fan_out = initializers.fan_in_out_conv(n_in, self.n_out, (kh, kw))
        w = initializers.xavier(gen, (self.n_out, n_in, kh, kw), fan_in, fan_out)
        return {"W": w, "b": initializers.zeros((self.n_out,))}

    def apply(self, params, x, train, gen, group=None):
        y = conv_transpose2d(x, params["W"], params["b"], self.stride,
                             self.padding, bf16=_mxu_bf16(self.bf16_matmul))
        return self._act(y), None


@dataclasses.dataclass
class MaxPool2D(Layer):
    """DL4J SubsamplingLayer(MAX)."""

    kernel: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)

    @property
    def has_params(self):
        return False

    def out_shape(self, in_shape):
        c, h, w = in_shape
        (kh, kw), (sh, sw) = self.kernel, self.stride
        return (c, (h - kh) // sh + 1, (w - kw) // sw + 1)

    def apply(self, params, x, train, gen, group=None):
        return max_pool2d(x, self.kernel, self.stride), None


@dataclasses.dataclass
class Upsampling2D(Layer):
    """DL4J Upsampling2D (nearest repeat; no activation)."""

    size: int = 2

    @property
    def has_params(self):
        return False

    def out_shape(self, in_shape):
        c, h, w = in_shape
        return (c, h * self.size, w * self.size)

    def apply(self, params, x, train, gen, group=None):
        return upsample2d(x, self.size), None


@dataclasses.dataclass
class BatchNorm(Layer):
    """DL4J BatchNormalization with its statistics as params (mean/var are
    read and written by name by the cross-graph weight syncs)."""

    n: Optional[int] = None
    decay: float = 0.9
    eps: float = 1e-5

    def out_shape(self, in_shape):
        return in_shape

    def init(self, gen, in_shape):
        n = self.n if self.n is not None else (
            in_shape[0] if len(in_shape) == 3 else math.prod(in_shape))
        return {"gamma": initializers.ones((n,)), "beta": initializers.zeros((n,)),
                "mean": initializers.zeros((n,)),
                "var": initializers.ones((n,))}

    def apply(self, params, x, train, gen, group=None):
        if not train:
            y = batch_norm_inference(x, params["gamma"], params["beta"],
                                     params["mean"], params["var"], self.eps)
            return self._act(y), None
        if x.dim() == 2:
            # BN+activation kernels on the card (JAX: graph/layers.py:298
            # routes only 2-D input to Pallas): one fused kernel, or under
            # a group of more than one rank the moments kernel, an
            # all-reduce and the apply kernel
            y, bmean, bvar = fused_bn_act_train(
                x, params["gamma"], params["beta"], self.eps,
                self.activation or "identity", group)
            return y, {
                "mean": self.decay * params["mean"] + (1 - self.decay) * bmean,
                "var": self.decay * params["var"] + (1 - self.decay) * bvar,
            }
        y, new_mean, new_var = batch_norm_train(
            x, params["gamma"], params["beta"], params["mean"], params["var"],
            self.decay, self.eps, group)
        return self._act(y), {"mean": new_mean, "var": new_var}


@dataclasses.dataclass
class Dropout(Layer):
    """DL4J DropoutLayer; rate 0.0 (the reference's unset default) is the
    identity."""

    rate: float = 0.0

    @property
    def has_params(self):
        return False

    def out_shape(self, in_shape):
        return in_shape

    def apply(self, params, x, train, gen, group=None):
        return dropout_op(x, self.rate, gen, train), None


@dataclasses.dataclass
class MinibatchStdDev(Layer):
    """Minibatch standard deviation (Karras et al. 2018), parameter-free:
    appends one channel (one feature for FF input) holding, for each
    contiguous group of ``group_size`` rows, the mean over positions of the
    rows' standard deviation.  Contiguous groups keep the D-step's real and
    fake halves apart.  A batch that ``group_size`` does not divide takes
    the largest group that does; under a group of more than one rank that
    raises instead, as the JAX layer does under a mesh (each rank's
    grouping would differ from the single-device run's).  The layer applies
    no activation."""

    group_size: int = 4
    eps: float = 1e-8

    @property
    def has_params(self):
        return False

    def out_shape(self, in_shape):
        if len(in_shape) == 3:
            c, h, w = in_shape
            return (c + 1, h, w)
        return (math.prod(in_shape) + 1,)

    def apply(self, params, x, train, gen, group=None):
        B = x.shape[0]
        g = self.group_size
        if B % g:
            if group is not None and group.world > 1:
                raise ValueError(
                    f"MinibatchStdDev: per-rank batch {B} not divisible by "
                    f"group_size {self.group_size}; pick a batch whose share "
                    "is a group multiple (the grouping must be the "
                    "single-device run's)")
            g = max(d for d in range(1, min(g, B) + 1) if B % d == 0)
        grouped = x.reshape((B // g, g) + tuple(x.shape[1:]))
        mean = torch.mean(grouped, dim=1, keepdim=True)
        var = torch.mean(torch.square(grouped - mean), dim=1)
        std = torch.sqrt(var + self.eps)
        # one scalar per group, broadcast to that group's rows
        stat = torch.mean(std.reshape(B // g, -1), dim=1)
        stat = stat[:, None].expand(B // g, g).reshape(B)
        if x.dim() == 4:
            feat = stat.reshape(B, 1, 1, 1).expand((B, 1) + tuple(x.shape[2:]))
        else:
            feat = stat.reshape(B, 1)
        return torch.cat([x, feat.to(x.dtype)], dim=1), None


@dataclasses.dataclass
class Merge(Layer):
    """DL4J MergeVertex: concatenation on the feature/channel axis (axis 0
    for 1-D input)."""

    @property
    def has_params(self):
        return False

    @property
    def multi_input(self):
        return True

    def out_shape(self, in_shape):
        return (sum(s[0] for s in in_shape),) + tuple(in_shape[0][1:])

    def apply(self, params, xs, train, gen, group=None):
        return torch.cat(list(xs), dim=1 if xs[0].dim() > 1 else 0), None


@dataclasses.dataclass
class ElementWise(Layer):
    """DL4J ElementWiseVertex: same-shaped inputs combined elementwise,
    ``op`` one of add, product, subtract (two inputs), average, max.  The
    explicit "identity" default keeps it free of the graph's default
    activation, as DL4J's vertex is."""

    op: str = "add"
    activation: Optional[str] = "identity"

    @property
    def has_params(self):
        return False

    @property
    def multi_input(self):
        return True

    def out_shape(self, in_shape):
        if self.op == "subtract" and len(in_shape) != 2:
            raise ValueError("subtract takes exactly two inputs")
        first = tuple(in_shape[0])
        for s in in_shape[1:]:
            if tuple(s) != first:
                raise ValueError(
                    f"ElementWise inputs must share a shape; got {in_shape}")
        return first

    def apply(self, params, xs, train, gen, group=None):
        if self.op == "add":
            out = sum(xs[1:], xs[0])
        elif self.op == "product":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
        elif self.op == "subtract":
            if len(xs) != 2:
                raise ValueError("subtract takes exactly two inputs")
            out = xs[0] - xs[1]
        elif self.op == "average":
            out = sum(xs[1:], xs[0]) / len(xs)
        elif self.op == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"unknown ElementWise op {self.op!r}")
        return self._act(out), None


@dataclasses.dataclass
class ConditionalBatchNorm(Layer):
    """Conditional BatchNorm (Dumoulin et al. 2017): batch statistics, one
    running mean/var as in plain BN, and per-class gamma/beta [K, n]
    selected by a one-hot condition.  Inputs (x, one-hot label).  At init
    every class row is gamma 1, beta 0: plain BN.  Applies its (inherited)
    activation after normalizing.  No kernel route: the JAX layer calls
    the plain op too."""

    num_classes: int = 0
    n: Optional[int] = None
    decay: float = 0.9
    eps: float = 1e-5

    @property
    def multi_input(self):
        return True

    def out_shape(self, in_shape):
        return tuple(in_shape[0])

    def init(self, gen, in_shape):
        x_shape = in_shape[0]
        n = self.n if self.n is not None else (
            x_shape[0] if len(x_shape) == 3 else math.prod(x_shape))
        if self.num_classes <= 0:
            raise ValueError("ConditionalBatchNorm needs num_classes > 0")
        k = self.num_classes
        return {"gamma": initializers.ones((k, n)),
                "beta": initializers.zeros((k, n)),
                "mean": initializers.zeros((n,)),
                "var": initializers.ones((n,))}

    def apply(self, params, xs, train, gen, group=None):
        x, y = xs
        # [B, n]: the one-hot row select; under --mp the label arrives
        # bf16 and, as jnp's matmul promotes it, meets the f32 gamma as f32
        y = y.to(params["gamma"].dtype)
        gamma_b = y @ params["gamma"]
        beta_b = y @ params["beta"]
        if train:
            out, new_mean, new_var = batch_norm_train_cond(
                x, gamma_b, beta_b, params["mean"], params["var"],
                self.decay, self.eps, group)
            return self._act(out), {"mean": new_mean, "var": new_var}
        return self._act(batch_norm_inference_cond(
            x, gamma_b, beta_b, params["mean"], params["var"], self.eps)), None


@dataclasses.dataclass
class ProjectionOutput(Layer):
    """Projection discriminator head (Miyato & Koyama 2018):
    ``logit = phi @ W + b + sum(phi * (y @ V), -1)``, inputs (features,
    one-hot label).  Carries a ``loss`` like ``Output``.  W: [n_in, 1],
    V: [K, n_in]."""

    n_in: Optional[int] = None
    num_classes: int = 0
    loss: str = "xent"

    @property
    def multi_input(self):
        return True

    def out_shape(self, in_shape):
        return (1,)

    def init(self, gen, in_shape):
        n_in = self.n_in if self.n_in is not None else math.prod(in_shape[0])
        k = self.num_classes
        if k <= 0:
            raise ValueError("ProjectionOutput needs num_classes > 0")
        return {"W": initializers.xavier(gen, (n_in, 1), n_in, 1),
                "b": initializers.zeros((1,)),
                "V": initializers.xavier(gen, (k, n_in), k, n_in)}

    def apply(self, params, xs, train, gen, group=None):
        phi, y = xs
        phi = _as_ff(phi)
        logit = phi @ params["W"] + params["b"]
        logit = logit + torch.sum(phi * (y @ params["V"]), dim=-1,
                                  keepdim=True)
        return self._act(logit), None
