"""The paper's experiment models (Sec 4.1) + small MLPs for tests
(PyTorch port of `repro.models.small`).

  - 4-layer CNN for FMNIST
  - VGG11s (slim VGG11) for CIFAR-10
  - 2-layer 128-unit LSTM for Speech Commands

Each model is init(gen) -> params (nested dict) and apply(params, x) ->
logits, with the reference's layouts. `make_task` builds a
core.simulator.TrainTask whose `init_fn(gen)` returns the *flat* fp32
parameter vector and whose `spec` maps it back to views; the synthetic
datasets are the reference's numpy streams.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import nn


# ------------------------------------------------------------------- CNN (FMNIST)
def cnn_init(gen, *, num_classes: int = 10, in_ch: int = 1):
    return {
        "conv1": nn.conv2d_init(gen, in_ch, 32, 5),
        "conv2": nn.conv2d_init(gen, 32, 64, 5),
        "fc1": nn.linear_init(gen, 64 * 7 * 7, 512),
        "fc2": nn.linear_init(gen, 512, num_classes),
    }


def cnn_apply(p, image):
    x = image
    x = torch.relu(nn.conv2d(p["conv1"], x))
    x = nn.max_pool(x)
    x = torch.relu(nn.conv2d(p["conv2"], x))
    x = nn.max_pool(x)
    # x is NHWC here, as in the reference: the flatten order is what gives
    # fc1's rows their meaning
    x = x.reshape((x.shape[0], -1))
    x = torch.relu(nn.linear(p["fc1"], x))
    return nn.linear(p["fc2"], x)


# --------------------------------------------------------------- VGG11s (CIFAR-10)
_VGG11S_PLAN = [(32, 1), ("M",), (64, 1), ("M",), (128, 2), ("M",),
                (256, 2), ("M",)]  # slim: half the channels of VGG11


def vgg11s_init(gen, *, num_classes: int = 10, in_ch: int = 3):
    params, ch, i = {}, in_ch, 0
    for item in _VGG11S_PLAN:
        if item[0] == "M":
            continue
        out_ch, reps = item
        for _ in range(reps):
            params[f"conv{i}"] = nn.conv2d_init(gen, ch, out_ch, 3)
            ch = out_ch
            i += 1
    params["fc1"] = nn.linear_init(gen, 256 * 2 * 2, 256)
    params["fc2"] = nn.linear_init(gen, 256, num_classes)
    return params


def vgg11s_apply(p, image):
    x, i = image, 0
    for item in _VGG11S_PLAN:
        if item[0] == "M":
            x = nn.max_pool(x)
            continue
        for _ in range(item[1]):
            x = torch.relu(nn.conv2d(p[f"conv{i}"], x))
            i += 1
    x = x.reshape((x.shape[0], -1))
    x = torch.relu(nn.linear(p["fc1"], x))
    return nn.linear(p["fc2"], x)


# ------------------------------------------------------------------- LSTM (SC)
def lstm_init(gen, *, features: int = 40, hidden: int = 128,
              num_classes: int = 10):
    return {"lstm1": nn.lstm_cell_init(gen, features, hidden),
            "lstm2": nn.lstm_cell_init(gen, hidden, hidden),
            "head": nn.linear_init(gen, hidden, num_classes)}


def lstm_apply(p, frames):
    h = nn.lstm_layer(p["lstm1"], frames)
    h = nn.lstm_layer(p["lstm2"], h)
    return nn.linear(p["head"], h[:, -1, :])


# --------------------------------------------------------------------- fast MLP
def mlp_init(gen, *, in_dim: int = 784, hidden: int = 128,
             num_classes: int = 10):
    return {"fc1": nn.linear_init(gen, in_dim, hidden),
            "fc2": nn.linear_init(gen, hidden, num_classes)}


def mlp_apply(p, image):
    x = image.reshape((image.shape[0], -1))
    x = torch.relu(nn.linear(p["fc1"], x))
    return nn.linear(p["fc2"], x)


# ------------------------------------------------------------------ task adapters
def softmax_xent(logits, labels):
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def params_from_jax(np_tree) -> torch.Tensor:
    """The JAX package's parameters (a nested dict of numpy arrays) as the
    port's flat fp32 buffer, in the same coordinate order."""
    from repro_torch.core.compression import flatten_pytree
    return flatten_pytree(np_tree)[0]


def make_task(name: str, *, num_samples: int = 4000, test_samples: int = 1000,
              batch_size: int = 64, seed: int = 0, noise: float | None = None):
    """Build a core.simulator.TrainTask for one of the paper's tasks
    (synthetic data stand-ins; see repro_torch.data.synthetic)."""
    from repro_torch.core.compression import flatten_pytree
    from repro_torch.core.simulator import TrainTask
    from repro_torch.data.synthetic import (SyntheticClassification,
                                            SyntheticSpeech)

    kw = {} if noise is None else {"noise": noise}
    if name == "mlp_micro":
        # tiny MLP (8x8 inputs, 32 hidden, d ~= 2.4k): runs are dominated
        # by harness overhead, not model FLOPs
        ds = SyntheticClassification(shape=(8, 8, 1), num_samples=num_samples,
                                     seed=seed, sample_seed=seed, **kw)
        test = SyntheticClassification(shape=(8, 8, 1),
                                       num_samples=test_samples, seed=seed,
                                       sample_seed=seed + 999, **kw)

        def init(gen):
            return mlp_init(gen, in_dim=64, hidden=32)
        apply, key_in = mlp_apply, "image"
    elif name in ("cnn_fmnist", "mlp_fmnist"):
        ds = SyntheticClassification(shape=(28, 28, 1), num_samples=num_samples,
                                     seed=seed, sample_seed=seed, **kw)
        test = SyntheticClassification(shape=(28, 28, 1),
                                       num_samples=test_samples, seed=seed,
                                       sample_seed=seed + 999, **kw)
        init, apply, key_in = (
            (cnn_init, cnn_apply, "image") if name == "cnn_fmnist"
            else (mlp_init, mlp_apply, "image"))
    elif name == "vgg11s_cifar10":
        ds = SyntheticClassification(shape=(32, 32, 3), num_samples=num_samples,
                                     seed=seed, sample_seed=seed, **kw)
        test = SyntheticClassification(shape=(32, 32, 3),
                                       num_samples=test_samples, seed=seed,
                                       sample_seed=seed + 999, **kw)
        init, apply, key_in = vgg11s_init, vgg11s_apply, "image"
    elif name == "lstm_sc":
        ds = SyntheticSpeech(num_samples=num_samples, seed=seed,
                             sample_seed=seed, **kw)
        test = SyntheticSpeech(num_samples=test_samples, seed=seed,
                               sample_seed=seed + 999, **kw)
        init, apply, key_in = lstm_init, lstm_apply, "frames"
    else:
        raise ValueError(f"unknown task {name}")

    test_batch = test.batch(np.arange(len(test)))
    _, spec = flatten_pytree(init(torch.Generator().manual_seed(0)))

    def loss_fn(params, batch):
        return softmax_xent(apply(params, batch[key_in]), batch["label"])

    def acc_fn(params, batch):
        return accuracy(apply(params, batch[key_in]), batch["label"])

    return TrainTask(name=name,
                     init_fn=lambda gen: flatten_pytree(init(gen))[0],
                     loss_fn=loss_fn, acc_fn=acc_fn, dataset=ds,
                     test_batch=test_batch, spec=spec, batch_size=batch_size)
