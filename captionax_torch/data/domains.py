"""Domain-conditioning embeddings for the Conceptual Captions hypernet: the
reference's six interchangeable schemes.

The port's own copy of ``captionax/data/domains.py`` (importing anything of
captionax runs its package init, which imports JAX).  Each scheme gives
(a) a host table ``domain -> id or vector``, built at construction in
numpy, and (b) a trainable projection applied on the device:

- ``one hot``          — domain id -> one-hot row, no trainable part;
  zero-shot domains get ids >= 100;
- ``embedding``        — a learned table [num_domains, hyper_emb];
- ``histograme``       — per-domain word-count histogram [V+1] -> MLP
  (V+1 -> 4h -> h, leaky ReLU after each);
- ``histograme log``   — log10(count + 1e-4) histogram -> the same MLP;
- ``histograme tfidf`` — tf-idf over the vocab-indexed histograms -> the
  same MLP;
- ``JSD``              — pairwise Jensen-Shannon distances of the domain
  histograms -> t-SNE to n_tsne dims -> Linear(n_tsne, h) + leaky ReLU.

As in captionax: a ``one hot`` id at or past the width embeds as the zero
row; the JSD coordinates of every domain are computed from the whole
distance matrix, so adding zero-shot domains moves the training domains'
coordinates too; and the embedding runs scikit-learn's ``TSNE`` where it
imports and classical MDS where it does not.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.data.cc import load_cc_captions
from captionax_torch.models.layers import mlp, mlp_init
from captionax_torch.train.state import tree_leaves

SCHEMES = (
    "one hot", "embedding", "histograme", "histograme log",
    "histograme tfidf", "JSD",
)


def word_histograms(
    cap_path: str, vocab, domains: Sequence[str], log_scale: bool = False
) -> Dict[str, np.ndarray]:
    """Per-domain word-count histogram over [len(vocab)+1] (the last slot
    counts out-of-vocab words), optionally log10(x + 1e-4).  Caption words
    are split on spaces, as the reference splits them."""
    V = len(vocab)
    hists = {d: np.zeros(V + 1) for d in domains}
    for _, caption, dom in load_cc_captions(cap_path):
        if dom not in hists:
            continue
        for word in caption.split(" "):
            if word in vocab.w2i:
                hists[dom][vocab.w2i[word]] += 1
            else:
                hists[dom][V] += 1
    if log_scale:
        eps = 1e-4
        for d in hists:
            hists[d] = np.log10(hists[d] + eps)
    return hists


def tfidf_histograms(
    cap_path: str, vocab, domains: Sequence[str]
) -> Dict[str, np.ndarray]:
    """tf-idf over the vocab-indexed histograms (smooth idf, l2-normalized,
    as scikit-learn's ``TfidfTransformer`` defaults)."""
    hists = word_histograms(cap_path, vocab, domains)
    mat = np.stack([hists[d] for d in domains])  # [D, V+1]
    n_docs = len(domains)
    df = (mat > 0).sum(axis=0)
    idf = np.log((1 + n_docs) / (1 + df)) + 1.0
    tfidf = mat * idf
    norms = np.linalg.norm(tfidf, axis=1, keepdims=True)
    tfidf = tfidf / np.maximum(norms, 1e-12)
    return {d: tfidf[i] for i, d in enumerate(domains)}


def jensen_shannon(p: np.ndarray, q: np.ndarray) -> float:
    """JS distance (the square root of the divergence, base e), as
    ``scipy.spatial.distance.jensenshannon``."""
    p = np.asarray(p, float)
    q = np.asarray(q, float)
    p_sum, q_sum = p.sum(), q.sum()
    if p_sum <= 0 or q_sum <= 0:
        return 0.0
    p, q = p / p_sum, q / q_sum
    m = (p + q) / 2

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    return math.sqrt(max(kl(p, m) / 2 + kl(q, m) / 2, 0.0))


def jsd_tsne_coords(
    cap_path: str,
    vocab,
    domains: Sequence[str],
    n_components: int = 2,
    zero_shot_path: str = "",
    zero_shot_domains: Sequence[str] = (),
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """The pairwise JSD matrix of the domain histograms -> t-SNE
    coordinates; classical MDS where scikit-learn is not installed."""
    hists = word_histograms(cap_path, vocab, domains)
    if zero_shot_domains:
        hists.update(word_histograms(zero_shot_path, vocab, zero_shot_domains))
    names = list(hists)
    H = np.stack([hists[d] for d in names])
    D = len(names)
    dist = np.zeros((D, D))
    for i in range(D):
        for j in range(D):
            dist[i, j] = jensen_shannon(H[i], H[j])
    dist = np.nan_to_num(dist)
    try:
        from sklearn.manifold import TSNE

        coords = TSNE(
            n_components=n_components, init="random",
            random_state=seed, perplexity=min(30.0, max(2.0, (D - 1) / 3)),
        ).fit_transform(dist)
    except Exception:  # classical MDS
        J = np.eye(D) - np.ones((D, D)) / D
        B = -0.5 * J @ (dist**2) @ J
        w, v = np.linalg.eigh(B)
        order = np.argsort(w)[::-1][:n_components]
        coords = v[:, order] * np.sqrt(np.maximum(w[order], 0))
    return {names[i]: coords[i].astype(np.float32) for i in range(D)}


class DomainEmbedder:
    """One object per scheme: the host table and the trainable params.

    ``init_params(generator, device)`` returns the trainable tree (empty
    for ``one hot``); ``embed(params, domain_value)`` returns the
    ``hyper_emb``-wide conditioning vector the hypernet consumes.
    ``domain_value`` is ``host_vector(domain)``, on the device or not: a
    0-d id for the id schemes, an f32 [V+1] or [n_tsne] vector otherwise.
    """

    def __init__(
        self,
        scheme: str,
        vocab,
        domains: Sequence[str],
        hyper_emb: int = 10,
        cap_path: str = "",
        n_tsne: int = 2,
        zero_shot_domains: Sequence[str] = (),
        zero_shot_path: str = "",
    ):
        assert scheme in SCHEMES, f"unknown scheme {scheme!r}"
        self.scheme = scheme
        self.vocab = vocab
        self.domains = [d.strip() for d in domains]
        self.zero_shot_domains = [d.strip() for d in zero_shot_domains]
        self.n_tsne = n_tsne
        self.table: Dict[str, object] = {}
        self.device = None  # set by init_params: where an id scheme's rows land

        if scheme == "one hot":
            # ids: training domains 0..D-1; zero-shot j+100 (reference quirk)
            ids = {d: i for i, d in enumerate(self.domains)}
            ids.update({d: 100 + j for j, d in enumerate(self.zero_shot_domains)})
            self.table = ids
            self.hyper_emb = max(ids.values()) + 1 if ids else 0
        elif scheme == "embedding":
            ids = {d: i for i, d in enumerate(self.domains)}
            ids.update(
                {d: len(self.domains) + j for j, d in enumerate(self.zero_shot_domains)}
            )
            self.table = ids
            self.num_entries = len(ids)
            self.hyper_emb = hyper_emb
        elif scheme in ("histograme", "histograme log", "histograme tfidf"):
            if scheme == "histograme tfidf":
                hists = tfidf_histograms(cap_path, vocab, self.domains)
                if self.zero_shot_domains:
                    hists.update(
                        tfidf_histograms(zero_shot_path, vocab, self.zero_shot_domains)
                    )
            else:
                log_scale = scheme == "histograme log"
                hists = word_histograms(cap_path, vocab, self.domains, log_scale)
                if self.zero_shot_domains:
                    hists.update(
                        word_histograms(
                            zero_shot_path, vocab, self.zero_shot_domains, log_scale
                        )
                    )
            self.table = {d: np.asarray(v, np.float32) for d, v in hists.items()}
            self.hyper_emb = hyper_emb
        elif scheme == "JSD":
            self.table = jsd_tsne_coords(
                cap_path, vocab, self.domains, n_tsne,
                zero_shot_path, self.zero_shot_domains,
            )
            self.hyper_emb = hyper_emb

    def init_params(self, generator: torch.Generator, device: DeviceLike = None):
        dev = self.device = resolve_device(device)
        if self.scheme == "one hot":
            return {}
        if self.scheme == "embedding":
            table = torch.randn((self.num_entries, self.hyper_emb), generator=generator)
            return {"table": table.to(dev)}
        if self.scheme == "JSD":
            return mlp_init(generator, (self.n_tsne, self.hyper_emb), device=dev)
        # the histogram MLP: V+1 -> 4h -> h, leaky ReLU after each
        return mlp_init(
            generator, (len(self.vocab) + 1, 4 * self.hyper_emb, self.hyper_emb), device=dev
        )

    def host_vector(self, domain: str):
        return self.table[domain.strip()]

    def register_zero_shot(self, params, domains, generator: torch.Generator):
        """Register unseen domains AFTER the params were restored.

        A tester must build the embedder as the trainer did (the same
        domains, the same appended pseudo-styles) or the restored shapes
        differ: the ``embedding`` table is [num_entries, hyper_emb], and
        the ``one hot`` width is the hypernet's input width.  Domains the
        trainer never saw are added here instead:

        - ``embedding``: appends rows drawn from ``generator`` (a row no
          batch ever trained);
        - ``one hot``: host ids only; an id past the trained width embeds
          as the zero row;
        - the histogram and JSD schemes raise ``ValueError``: their MLPs
          take any domain, so pass the domains at construction.

        Returns the (possibly grown) ``params``; the host table grows in
        place."""
        new = [d.strip() for d in domains
               if d.strip() and d.strip() not in self.table]
        if not new:
            return params
        if self.scheme == "one hot":
            base = 100 + len(self.zero_shot_domains)
            for j, d in enumerate(new):
                self.table[d] = base + j
            self.zero_shot_domains += new
            return params
        if self.scheme == "embedding":
            for j, d in enumerate(new):
                self.table[d] = self.num_entries + j
            self.num_entries += len(new)
            self.zero_shot_domains += new
            table = params["table"]
            rows = torch.randn((len(new), self.hyper_emb), generator=generator)
            params = dict(params)
            params["table"] = torch.cat([table, rows.to(table.device, table.dtype)])
            return params
        raise ValueError(
            f"scheme {self.scheme!r} embeds arbitrary domains already; "
            "pass them at construction via zero_shot_domains")

    def embed(self, params, domain_value) -> torch.Tensor:
        if self.scheme == "one hot":
            # on the value's device when it is a tensor, else where
            # init_params put the model; a zero row for an id at or past the
            # width, as jax.nn.one_hot gives (F.one_hot raises there)
            dev = (domain_value.device if isinstance(domain_value, torch.Tensor)
                   else self.device or torch.device("cpu"))
            value = torch.as_tensor(domain_value).to(dev).long()
            return (value[..., None]
                    == torch.arange(self.hyper_emb, device=dev)).to(torch.float32)
        value = torch.as_tensor(domain_value).to(tree_leaves(params)[0].device)
        if self.scheme == "embedding":
            return params["table"][value.long()]
        return mlp(params, value.to(torch.float32), final_act=True)
