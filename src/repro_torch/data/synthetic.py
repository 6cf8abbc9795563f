"""Synthetic stand-ins for the paper's datasets (offline container).

The paper trains CNN@FMNIST (28x28x1, 10 classes), VGG11s@CIFAR-10
(32x32x3, 10 classes) and LSTM@SC (speech commands: 1s audio -> MFCC
frames, 10-35 classes). No datasets ship offline, so we generate
learnable synthetic tasks with the same shapes and difficulty knobs:
class-prototype + structured noise. Accuracy-vs-time *ratios between
methods* (what the paper reports) are preserved because every method
trains on the identical stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticClassification:
    """Images drawn as class prototype + low-rank distortion + pixel noise."""
    num_classes: int = 10
    shape: tuple = (28, 28, 1)   # FMNIST-like; (32,32,3) for CIFAR-like
    num_samples: int = 10_000
    noise: float = 0.35          # per-pixel noise std
    signal: float = 4.0          # prototype norm (class-signal strength)
    seed: int = 0                # fixes the task (prototypes + mixing)
    sample_seed: int = 0         # fixes the draw (train vs test split)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)          # task randomness
        srng = np.random.RandomState(self.sample_seed + 104729)  # draw
        d = int(np.prod(self.shape))
        self.prototypes = rng.randn(self.num_classes, d).astype(np.float32)
        self.prototypes *= self.signal / np.linalg.norm(
            self.prototypes, axis=1, keepdims=True)
        self.mix = rng.randn(8, d).astype(np.float32) / np.sqrt(d)
        self.labels = srng.randint(0, self.num_classes, self.num_samples)
        coeff = srng.randn(self.num_samples, 8).astype(np.float32)
        noise = srng.randn(self.num_samples, d).astype(np.float32) * self.noise
        x = self.prototypes[self.labels] + coeff @ self.mix * 0.5 + noise
        self.images = x.reshape((self.num_samples,) + self.shape)

    def __len__(self):
        return self.num_samples

    def batch(self, idx: np.ndarray):
        return {"image": self.images[idx], "label": self.labels[idx]}


@dataclasses.dataclass
class SyntheticSpeech:
    """SC-like: [T, F] MFCC-ish frames, class = prototype trajectory."""
    num_classes: int = 10
    seq_len: int = 49
    features: int = 40
    num_samples: int = 8_000
    noise: float = 0.4
    signal: float = 0.5          # per-element prototype scale
    seed: int = 1                # fixes the task (prototypes)
    sample_seed: int = 0         # fixes the draw (train vs test split)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        srng = np.random.RandomState(self.sample_seed + 104729)
        self.proto = rng.randn(self.num_classes, self.seq_len,
                               self.features).astype(np.float32)
        self.proto *= self.signal
        self.labels = srng.randint(0, self.num_classes, self.num_samples)
        noise = srng.randn(self.num_samples, self.seq_len,
                          self.features).astype(np.float32) * self.noise
        self.frames = self.proto[self.labels] + noise

    def __len__(self):
        return self.num_samples

    def batch(self, idx: np.ndarray):
        return {"frames": self.frames[idx], "label": self.labels[idx]}


@dataclasses.dataclass
class SyntheticTokens:
    """LM token stream with Zipfian unigram + short-range bigram structure."""
    vocab: int = 32_000
    seq_len: int = 128
    num_samples: int = 4_096
    seed: int = 2

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks ** 1.1
        p /= p.sum()
        flat = rng.choice(self.vocab, size=self.num_samples * self.seq_len, p=p)
        # inject copy structure: token[t] = token[t-8] with prob .25
        flat = flat.reshape(self.num_samples, self.seq_len)
        for t in range(8, self.seq_len):
            m = rng.rand(self.num_samples) < 0.25
            flat[m, t] = flat[m, t - 8]
        self.tokens = flat.astype(np.int32)

    def __len__(self):
        return self.num_samples

    def batch(self, idx: np.ndarray):
        tok = self.tokens[idx]
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def make_task_dataset(task: str, **kw):
    """Factory matching the paper's three tasks."""
    if task in ("fmnist", "cnn_fmnist"):
        return SyntheticClassification(shape=(28, 28, 1), **kw)
    if task in ("cifar10", "vgg11s_cifar10"):
        return SyntheticClassification(shape=(32, 32, 3), **kw)
    if task in ("sc", "lstm_sc"):
        return SyntheticSpeech(**kw)
    if task == "lm":
        return SyntheticTokens(**kw)
    raise ValueError(f"unknown task {task}")
