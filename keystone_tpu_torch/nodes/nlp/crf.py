"""Linear-chain CRF tagger: hashed emission features, exact NLL, L-BFGS.

Counterpart of `keystone_tpu/nodes/nlp/crf.py` (reference
POSTagger.scala:24-36, NER.scala:20-32, which wrap Epic's pretrained
linear-chain CRFs):

- `_hash_features` (`:29-38`, crc32 of each of the 12 emission features
  mod ``n_buckets``) and `_pad_batch` (`:41-50`), copied: the ids equal
  JAX's;
- `CRFObjective` is `train`'s ``nll`` (`:94-128`) over one flat float32
  ``theta`` laid out as ``unpack`` does: emissions (n_buckets, T), then
  transitions (T, T) prev → next, then the start scores (T,). The
  emissions of a token are a sum of 12 gathered rows
  (`F.embedding_bag`), the forward recursion runs in log space over the
  L − 1 steps with the mask carrying alpha over padded steps, and the
  gold score reads the padded gold entries (zeros) and masks them after,
  as JAX's does. The gradient comes from autograd;
- `LinearChainCRFTagger.train` (`:71-155`) minimizes it from zeros with
  `lbfgs_minimize`, the port's copy of ``optax.lbfgs()`` with the
  defaults JAX's CRF calls it with (memory 10, optax's zoom line
  search), and stops by JAX's rule (`:142-148`, `jax_stop`);
- `_viterbi` is the batched decode of `_decoder` (`:159-203`): a max and
  an argmax over the previous tag (the first maximal index, as
  `jnp.argmax`), identity backpointers on masked steps, then the
  backtrack; `predict_batch` pads a call's sentences to one power of two
  from 8 (`_bucket`, `:206-210`).

The gather, the recursion and the decode are plain torch ops on the
device: the JAX package computes them in plain ``jnp`` and
``lax.scan``, outside any Pallas kernel. On the card the backward of the
gather adds into the emission table with atomics, so a fit's weights are
not bit-stable there; the card's fit is held by its accuracy and final
NLL, and its decode and objective against the CPU path on the same
``theta`` (`chip_smoke.py`'s ``nlp`` phase).
"""

from __future__ import annotations

import time
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device
from ..learning.lbfgs import lbfgs_minimize
from .perceptron_tagger import _emission_features

_N_FEATS = 12  # _emission_features always yields exactly this many


def _hash_features(tokens: Sequence[str], n_buckets: int) -> np.ndarray:
    """(len(tokens), _N_FEATS) int32 hashed feature ids (stable crc32)."""
    out = np.empty((len(tokens), _N_FEATS), np.int32)
    for i in range(len(tokens)):
        feats = _emission_features(tokens, i)
        assert len(feats) == _N_FEATS, (
            "emission feature template changed; update _N_FEATS")
        for k, f in enumerate(feats):
            out[i, k] = zlib.crc32(f.encode()) % n_buckets
    return out


def _pad_batch(fid_list: List[np.ndarray], pad_len: int):
    """Stack ragged (Lᵢ, K) id arrays to (N, pad_len, K) + bool mask."""
    n = len(fid_list)
    fids = np.zeros((n, pad_len, _N_FEATS), np.int32)
    mask = np.zeros((n, pad_len), bool)
    for i, f in enumerate(fid_list):
        ln = min(len(f), pad_len)
        fids[i, :ln] = f[:ln]
        mask[i, :ln] = True
    return fids, mask


def unpack(theta: torch.Tensor, n_buckets: int, n_tags: int):
    """(emit (n_buckets, T), trans (T, T), start (T,)) views of ``theta``
    (`:94-99`)."""
    e = n_buckets * n_tags
    return (theta[:e].view(n_buckets, n_tags),
            theta[e:e + n_tags * n_tags].view(n_tags, n_tags),
            theta[e + n_tags * n_tags:])


def _emissions(emit: torch.Tensor, fids: torch.Tensor) -> torch.Tensor:
    """(N, L, K) ids → (N, L, T): each token's K rows of ``emit`` summed."""
    n, length, k = fids.shape
    return F.embedding_bag(fids.reshape(-1, k), emit, mode="sum").view(
        n, length, emit.shape[1])


class CRFObjective:
    """The mean negative log-likelihood of the gold tag paths plus
    ``l2``·Σθ² (`:101-128`), as the ``(value, gradient)`` callable
    `lbfgs_minimize` takes. ``fids`` (N, L, K), ``mask`` (N, L) and
    ``gold`` (N, L) are host arrays, copied to ``device`` once."""

    def __init__(self, fids, mask, gold, n_buckets: int, n_tags: int,
                 l2: float, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        self.fids = torch.as_tensor(np.asarray(fids, np.int64), device=dev)
        self.mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
        self.maskf = self.mask.float()
        self.gold = torch.as_tensor(np.asarray(gold, np.int64), device=dev)
        self.n_buckets, self.n_tags, self.l2 = n_buckets, n_tags, float(l2)

    @property
    def size(self) -> int:
        """The length of ``theta``: n_buckets·T + T² + T."""
        t = self.n_tags
        return self.n_buckets * t + t * t + t

    def nll(self, theta: torch.Tensor) -> torch.Tensor:
        emit, trans, start = unpack(theta, self.n_buckets, self.n_tags)
        emis = _emissions(emit, self.fids)
        # forward recursion (log space); masked steps carry alpha
        alpha = start[None, :] + emis[:, 0]
        for i in range(1, emis.shape[1]):
            nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
                + emis[:, i]
            alpha = torch.where(self.mask[:, i, None], nxt, alpha)
        log_z = torch.logsumexp(alpha, dim=-1)
        # the gold path's score; padded gold entries are 0 and masked
        gold, m = self.gold, self.maskf
        e_gold = emis.gather(2, gold[:, :, None])[:, :, 0]
        e_score = (e_gold * m).sum(dim=1)
        t_score = (trans[gold[:, :-1], gold[:, 1:]] * m[:, 1:]).sum(dim=1)
        s_score = start[gold[:, 0]]
        reg = self.l2 * torch.sum(theta * theta)
        return torch.mean(log_z - (e_score + t_score + s_score)) + reg

    def __call__(self, theta: torch.Tensor):
        with torch.enable_grad():
            leaf = theta.detach().requires_grad_(True)
            value = self.nll(leaf)
            (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), grad


def jax_stop(history: List[float]) -> bool:
    """JAX's rule (`:142-148`): after step ``it`` (0-based), stop when
    ``it > 10`` and the start values of steps ``it − 1`` and ``it``
    differ by less than 1e-7·max(1, |v|)."""
    it = len(history) - 1
    if it <= 10:
        return False
    last, v = history[-2], history[-1]
    return abs(last - v) < 1e-7 * max(1.0, abs(v))


class LinearChainCRFTagger:
    """Callable tokens → tags, like the perceptron taggers, so it plugs
    straight into ``POSTagger``/``NER`` via their ``model=`` hook.
    ``device``: where ``theta`` lives, the fit runs and tags are decoded
    (the card by default; without one this raises unless it is "cpu").
    After `train`: ``emit``, ``trans`` and ``start`` on the device;
    ``loss_history`` (the NLL at the start of each L-BFGS step),
    ``linesearch_steps`` (each step's evaluations) and
    ``hash_seconds`` (the host's feature hashing)."""

    def __init__(self, n_buckets: int = 1 << 15, l2: float = 1e-4,
                 max_iter: int = 120, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.n_buckets = n_buckets
        self.l2 = l2
        self.max_iter = max_iter
        self.seed = seed
        self.device = resolve_device(device)
        self.tags: List[str] = []
        self.emit: Optional[torch.Tensor] = None   # (n_buckets, T)
        self.trans: Optional[torch.Tensor] = None  # (T, T) prev→next
        self.start: Optional[torch.Tensor] = None  # (T,)
        self.loss_history: List[float] = []
        self.linesearch_steps: List[int] = []
        self.hash_seconds = 0.0

    # -------------------------------------------------------------- training

    def objective(self, sentences) -> CRFObjective:
        """The NLL over ``sentences`` (non-empty lists of (token, tag)),
        with ``tags`` set from them, sorted (`:76-92`)."""
        sentences = [list(s) for s in sentences if len(s) > 0]
        self.tags = sorted({t for s in sentences for _, t in s})
        tag_id = {t: i for i, t in enumerate(self.tags)}
        max_len = max(len(s) for s in sentences)
        t0 = time.perf_counter()
        fid_list = [_hash_features([w for w, _ in s], self.n_buckets)
                    for s in sentences]
        self.hash_seconds = time.perf_counter() - t0
        fids, mask = _pad_batch(fid_list, max_len)
        gold = np.zeros((len(sentences), max_len), np.int32)
        for i, s in enumerate(sentences):
            gold[i, : len(s)] = [tag_id[t] for _, t in s]
        return CRFObjective(fids, mask, gold, self.n_buckets,
                            len(self.tags), self.l2, self.device)

    def train(self, sentences) -> "LinearChainCRFTagger":
        objective = self.objective(sentences)
        theta = torch.zeros(objective.size, dtype=torch.float32,
                            device=self.device)
        theta, self.loss_history, self.linesearch_steps = lbfgs_minimize(
            objective, theta, self.max_iter, memory_size=10, stop=jax_stop)
        self.set_theta(theta)
        return self

    def set_theta(self, theta: torch.Tensor) -> None:
        """Take ``emit``, ``trans`` and ``start`` from a flat ``theta``
        laid out as `unpack` reads it."""
        emit, trans, start = unpack(theta.to(self.device), self.n_buckets,
                                    len(self.tags))
        self.emit, self.trans, self.start = (
            emit.contiguous(), trans.contiguous(), start.contiguous())

    @property
    def theta(self) -> torch.Tensor:
        """The weights as one flat vector, laid out as `unpack` reads it."""
        return torch.cat([self.emit.reshape(-1), self.trans.reshape(-1),
                          self.start])

    # ------------------------------------------------------------- inference

    def _viterbi(self, fids: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
        """Batched Viterbi (`_decoder`, `:172-198`): (B, L, K) ids and a
        (B, L) mask on the device → (B, L) tag ids."""
        emis = _emissions(self.emit, fids)
        b, length, t = emis.shape
        alpha = self.start[None, :] + emis[:, 0]
        ident = torch.arange(t, device=emis.device).expand(b, t)
        bps = []
        for i in range(1, length):
            cand = alpha[:, :, None] + self.trans[None]  # (B, prev, next)
            best, best_prev = torch.max(cand, dim=1)
            m = mask[:, i, None]
            alpha = torch.where(m, best + emis[:, i], alpha)
            bps.append(torch.where(m, best_prev, ident))
        tag = torch.argmax(alpha, dim=-1)
        path = [tag]
        for bp in reversed(bps):
            tag = bp.gather(1, tag[:, None])[:, 0]
            path.append(tag)
        return torch.stack(path[::-1], dim=1)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def predict_batch(self, token_lists: Sequence[Sequence[str]]
                      ) -> List[List[str]]:
        if self.emit is None:
            raise RuntimeError("train() or load() first")
        out: List[List[str]] = [[] for _ in token_lists]
        todo = [(i, toks) for i, toks in enumerate(token_lists) if toks]
        if not todo:
            return out
        pad_len = self._bucket(max(len(t) for _, t in todo))
        fids, mask = _pad_batch(
            [_hash_features(toks, self.n_buckets) for _, toks in todo],
            pad_len)
        ids = self._viterbi(
            torch.as_tensor(fids.astype(np.int64), device=self.device),
            torch.as_tensor(mask, device=self.device)).cpu().numpy()
        for (i, toks), row in zip(todo, ids):
            out[i] = [self.tags[j] for j in row[: len(toks)]]
        return out

    def predict(self, tokens: Sequence[str]) -> List[str]:
        return self.predict_batch([tokens])[0]

    __call__ = predict

    # ----------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """JAX's ``.npz`` (`:236-240`): a file either package loads."""
        np.savez_compressed(
            path, tags=np.asarray(self.tags),
            emit=self.emit.cpu().numpy(), trans=self.trans.cpu().numpy(),
            start=self.start.cpu().numpy(), n_buckets=self.n_buckets)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda"
             ) -> "LinearChainCRFTagger":
        blob = np.load(path, allow_pickle=False)
        t = cls(n_buckets=int(blob["n_buckets"]), device=device)
        t.tags = [str(x) for x in blob["tags"]]
        t.emit, t.trans, t.start = (
            torch.as_tensor(np.asarray(blob[k], np.float32),
                            device=t.device)
            for k in ("emit", "trans", "start"))
        return t
