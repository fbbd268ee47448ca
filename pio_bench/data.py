"""The benchmark's inputs, made on the device from ``--seed``.

One general generator for every rating configuration. It keeps the
published marginals of the dataset the configuration names:

- **users**: exactly ``n_users`` users, whose rating counts lie between
  the published least and most (``user_ratings``) and sum to exactly
  ``n_ratings``. The counts follow a log-normal law (the law is the
  assumption, under ``assumed`` in the config file): the count of the
  user at quantile ``q`` is ``exp(mu + sigma * Phi^-1(q))``, clipped to
  the published range, with ``mu`` and ``sigma`` fitted so that the most
  active user has the published most and the counts sum to the
  published total. The same counts every seed; the seed only chooses
  which user id gets which count.
- **items**: each user's items are drawn without replacement (no pair
  occurs twice, as in the datasets), by successive sampling with
  weights ``1 / rank^s`` over the items' popularity ranks (the Zipf-like
  law is assumed). ``s`` is fitted so that the expected count of the
  most rated item is the published one (``item_ratings.max``): the
  expectation takes each user's inclusion probability of item ``j`` as
  ``1 - exp(-tau_u w_j)``, with ``tau_u`` such that those probabilities
  sum to the user's count. The seed chooses which item id has which
  rank.
- **ratings**: drawn from a normal distribution, rounded to the scale's
  step and clipped to it; then the entries are shuffled, as an event log
  holds them.

Then the initial factors, MLlib's ``|N(0, 1)| / sqrt(rank)``. All random
draws come from one ``torch.Generator`` on ``device``, in blocks of a
few hundred million keys (each user's draw is a top-k of exponential
keys over ``1 / w``), so one seed gives the same tensors in every run,
and the port and the reference are handed the same ones. The fits are
float64 arithmetic on fixed numbers and draw nothing.

The port's own generator (``predictionio_tpu_torch/data/synthetic.py``)
is not imported, so a change to it cannot move the yardstick.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

#: seeds are any whole number; the generator takes 64 bits
_SEED_BITS = (1 << 64) - 1

#: keys (float32) drawn in one block of users
_BLOCK_KEYS = 1 << 27

#: points of the grid on which ``tau -> sum_j (1 - exp(-tau w_j))`` is
#: tabulated and inverted, and rows of it evaluated at once
_GRID = 2048
_GRID_ROWS = 128


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _SEED_BITS)
    return g


def user_counts(n_users: int, n_ratings: int, least: int, most: int,
                device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Every user's rating count, most active first: int64 on the CPU,
    each in ``[least, most]``, the first ``most``, summing to
    ``n_ratings``; a clipped log-normal profile (see the module), fitted
    on ``device``."""
    if not (least * n_users <= n_ratings <= most * n_users
            and least <= most):
        raise ValueError(f"{n_ratings} ratings cannot be spread over "
                         f"{n_users} users at {least} to {most} each")
    k = torch.arange(n_users, dtype=torch.float64, device=device)
    z = torch.special.ndtri(1.0 - (k + 0.5) / n_users)
    z = z - z[0]

    def profile(sigma: float) -> torch.Tensor:
        x = torch.exp(math.log(most) + sigma * z).clamp_(least, most)
        x[0] = most
        return x

    # the sum falls as sigma grows; keep profile(lo).sum() >= n_ratings
    lo, hi = 0.0, 1.0
    while float(profile(hi).sum()) > n_ratings and hi < 1e3:
        lo, hi = hi, 2 * hi
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if float(profile(mid).sum()) >= n_ratings:
            lo = mid
        else:
            hi = mid
    x = profile(lo)
    counts = torch.floor(x)
    short = n_ratings - int(counts.sum())
    # largest remainders first; an entry with a remainder lies below
    # ``most``, so one more keeps it in range and the order descending
    order = torch.argsort(x - counts, descending=True, stable=True)
    counts[order[:short]] += 1
    return counts.to(device="cpu", dtype=torch.int64)


def _inclusion_sums(tau: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_j (1 - exp(-tau w_j))`` for each tau."""
    out = torch.empty_like(tau)
    for a in range(0, tau.numel(), _GRID_ROWS):
        t = tau[a:a + _GRID_ROWS, None]
        out[a:a + _GRID_ROWS] = (-torch.expm1(-t * w[None, :])).sum(1)
    return out


def _expected_top(s: float, n_items: int, values: torch.Tensor,
                  users: torch.Tensor) -> float:
    """Expected ratings of the most popular item under weights
    ``1 / rank^s``, ``users[v]`` users taking ``values[v]`` items each."""
    device = values.device
    w = torch.arange(1, n_items + 1, dtype=torch.float64,
                     device=device).pow_(-s)
    tau = torch.exp(torch.linspace(
        math.log(0.25 * float(values.min()) / float(w.sum())),
        math.log(60.0 / float(w[-1])), _GRID, dtype=torch.float64,
        device=device))
    f = _inclusion_sums(tau, w)
    # invert f (increasing) by linear interpolation in log tau
    j = torch.searchsorted(f, values).clamp_(1, _GRID - 1)
    f0, f1 = f[j - 1], f[j]
    lt0, lt1 = tau[j - 1].log(), tau[j].log()
    share = ((values - f0) / (f1 - f0)).clamp_(0, 1)
    t = torch.exp(lt0 + share * (lt1 - lt0))
    return float((users * -torch.expm1(-t)).sum())


def item_exponent(n_items: int, counts: torch.Tensor, top: int,
                  device: torch.device) -> float:
    """The ``s`` of ``1 / rank^s`` at which the most popular item's
    expected count is ``top``."""
    values, users = torch.unique(counts, return_counts=True)
    values = values.to(device=device, dtype=torch.float64)
    users = users.to(device=device, dtype=torch.float64)
    lo, hi = 0.0, 4.0
    if not (_expected_top(lo, n_items, values, users) <= top
            <= _expected_top(hi, n_items, values, users)):
        raise ValueError(f"no item skew gives the most rated item {top} "
                         f"ratings")
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        if _expected_top(mid, n_items, values, users) < top:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def ratings(cfg: dict, g: torch.Generator, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(user, item, rating): int32, int32, float32 tensors of
    ``cfg["n_ratings"]`` entries on ``device``, no (user, item) pair
    twice."""
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    n = int(cfg["n_ratings"])
    counts = user_counts(n_users, n, int(cfg["user_ratings"]["min"]),
                         int(cfg["user_ratings"]["max"]), device)
    if int(counts[0]) > n_items:
        raise ValueError(f"a user cannot rate {int(counts[0])} of "
                         f"{n_items} items once each")
    s = item_exponent(n_items, counts, int(cfg["item_ratings"]["max"]),
                      device)
    inv_w = torch.arange(1, n_items + 1, dtype=torch.float64,
                         device=device).pow_(s).to(torch.float32)
    user_of = torch.randperm(n_users, generator=g, device=device)
    item_of = torch.randperm(n_items, generator=g, device=device)
    on_device = counts.to(device)
    users, items = [], []
    a = 0
    while a < n_users:
        most = int(counts[a])
        b = min(n_users, a + max(1, _BLOCK_KEYS // max(n_items, 3 * most)))
        keys = torch.empty((b - a, n_items), dtype=torch.float32,
                           device=device).exponential_(generator=g)
        keys.mul_(inv_w)
        ranks = torch.topk(keys, most, dim=1, largest=False,
                           sorted=True).indices
        del keys
        keep = torch.arange(most, device=device) < on_device[a:b, None]
        items.append(item_of[ranks[keep]])
        users.append(torch.repeat_interleave(
            user_of[a:b], on_device[a:b],
            output_size=int(counts[a:b].sum())))
        del ranks, keep
        a = b
    order = torch.randperm(n, generator=g, device=device)
    user = torch.cat(users)[order].to(torch.int32)
    item = torch.cat(items)[order].to(torch.int32)
    del users, items, order
    scale = cfg["rating_scale"]
    r = torch.normal(float(scale["mean"]), float(scale["std"]), (n,),
                     generator=g, dtype=torch.float32, device=device)
    step = float(scale["step"])
    r = torch.clamp(torch.round(r / step) * step, float(scale["min"]),
                    float(scale["max"]))
    return user, item, r


def initial_factors(cfg: dict, g: torch.Generator, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U0, V0): ``|N(0, 1)| / sqrt(rank)``, float32, on ``device``."""
    rank = int(cfg["rank"])
    scale = float(rank) ** -0.5

    def draw(n: int) -> torch.Tensor:
        x = torch.randn((n, rank), generator=g, dtype=torch.float32,
                        device=device)
        return x.abs_().mul_(scale)

    return draw(int(cfg["n_users"])), draw(int(cfg["n_items"]))


def inputs(cfg: dict, seed: int, device: torch.device):
    """Everything one run hands the program and the reference:
    ((user, item, rating), (U0, V0))."""
    g = generator(seed, device)
    coo = ratings(cfg, g, device)
    return coo, initial_factors(cfg, g, device)
