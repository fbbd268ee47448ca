"""Stock prediction + backtesting engine (port of
``predictionio_tpu/examples/stock.py``).

Parity: examples/experimental/scala-stock —
``Indicators.scala`` (RSIIndicator, ShiftsIndicator over log-price series),
``RegressionStrategy.scala`` (per-ticker linear regression of the 1-day
forward return on indicator features), ``BackTestingMetrics.scala``
(BacktestingParams enter/exit thresholds, NAV series, return/vol/Sharpe).

The reference regresses ticker-by-ticker with breeze in one process. Here
the whole market is one (tickers, days, features) tensor and every
ticker's least-squares solve runs as one batched solve on the context's
device (the card unless the caller asks for the CPU), with indicators
computed as vectorized rolling ops over the full price frame on the host.

The solve is :func:`lstsq_min_norm`: a batched SVD and JAX's
``jnp.linalg.lstsq`` cutoff (singular values below ``eps * max(m, n)``
times the largest are dropped), the minimum-norm answer on every device.
``torch.linalg.lstsq`` on CUDA offers only the ``gels`` routine, which
assumes full rank: a delisted or constant ticker (a zero feature column)
would give another or a non-finite answer on the card.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource, EmptyEvaluationInfo, FirstServing, IdentityPreparator,
    Params, SimpleEngine,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.controller.metric import Metric


# ---------------------------------------------------------------------------
# Indicators (Indicators.scala)
# ---------------------------------------------------------------------------

class BaseIndicator:
    """Vectorized indicator over a (days,) log-price series."""

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        """Full-history indicator series, same length as input."""
        raise NotImplementedError

    def get_one(self, log_price: np.ndarray) -> float:
        return float(self.get_training(log_price)[-1])

    def min_window(self) -> int:
        raise NotImplementedError


class ShiftsIndicator(BaseIndicator):
    """Return over `period` days: x_t - x_{t-period}
    (ShiftsIndicator, Indicators.scala)."""

    def __init__(self, period: int):
        self.period = period

    def min_window(self) -> int:
        return self.period + 1

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        out = np.zeros_like(log_price)
        p = self.period
        out[p:] = log_price[p:] - log_price[:-p]
        return out


class RSIIndicator(BaseIndicator):
    """Relative Strength Index over daily returns
    (RSIIndicator, Indicators.scala): rolling mean of positive vs negative
    return magnitudes, RSI = 100 - 100/(1+RS), NaN windows -> neutral 50."""

    def __init__(self, rsi_period: int = 14):
        self.rsi_period = rsi_period

    def min_window(self) -> int:
        return self.rsi_period + 1

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        ret = np.zeros_like(log_price)
        ret[1:] = log_price[1:] - log_price[:-1]
        pos = np.where(ret > 0, ret, 0.0)
        # loss MAGNITUDE: the reference feeds the signed negative series
        # into RS (Indicators.scala calcRS), which pushes RSI outside
        # [0,100] on any mixed window — textbook RSI negates it
        neg = np.where(ret < 0, -ret, 0.0)
        kernel = np.ones(self.rsi_period) / self.rsi_period
        # rolling means aligned to the window's END (trailing period)
        avg_pos = np.convolve(pos, kernel, mode="full")[:len(pos)]
        avg_neg = np.convolve(neg, kernel, mode="full")[:len(neg)]
        with np.errstate(divide="ignore", invalid="ignore"):
            rs = avg_pos / avg_neg
            rsi = 100.0 - 100.0 / (1.0 + rs)
        # all-gain windows: avg_neg 0 -> rs inf -> rsi 100; 0/0 -> neutral
        rsi[np.isnan(rsi)] = 50.0
        rsi[:self.rsi_period] = 50.0    # not enough history -> neutral
        return rsi


# ---------------------------------------------------------------------------
# Data (DataSource.scala / YahooDataSource.scala role)
# ---------------------------------------------------------------------------

@dataclass
class StockTrainingData:
    tickers: List[str]
    prices: np.ndarray     # (days, tickers) raw close prices
    active: np.ndarray     # (days, tickers) bool


@dataclass(frozen=True)
class QueryDate:
    """Predict FROM day `idx`. `prices` is the observable history through
    that day ((idx+1, tickers) — what a live system would have at the
    close of day idx); when None (plain deploy-time query) the model's
    own trailing window stands in."""
    idx: int
    prices: Optional[np.ndarray] = None


@dataclass
class StockPrediction:
    data: Dict[str, float]   # ticker -> predicted next-day log return


@dataclass(frozen=True)
class StockDataSourceParams(Params):
    filepath: str            # CSV: header "date,TICK1,TICK2,..."; rows close
    trainUntilIdx: int       # first eval window starts here
    evalInterval: int = 5    # days per eval window
    evalCount: int = 3


class StockDataSource(DataSource):
    params_class = StockDataSourceParams

    def __init__(self, params: StockDataSourceParams):
        self.dsp = params

    def _frame(self) -> StockTrainingData:
        with open(self.dsp.filepath) as f:
            header = f.readline().strip().split(",")[1:]
            rows = [[float(v) for v in line.strip().split(",")[1:]]
                    for line in f if line.strip()]
        prices = np.asarray(rows, dtype=np.float64)
        return StockTrainingData(
            tickers=list(header), prices=prices,
            active=np.isfinite(prices) & (prices > 0))

    def read_training(self, ctx) -> StockTrainingData:
        return self._frame()

    def read_eval(self, ctx):
        """Walk-forward windows (the reference's rolling DataParams):
        train on days < t, query each day in [t, t+interval)."""
        data = self._frame()
        sets = []
        for w in range(self.dsp.evalCount):
            t = self.dsp.trainUntilIdx + w * self.dsp.evalInterval
            hi = min(t + self.dsp.evalInterval, data.prices.shape[0] - 1)
            if t >= hi:
                break
            train = StockTrainingData(
                tickers=data.tickers, prices=data.prices[:t],
                active=data.active[:t])
            # each query carries its own observable history so the daily
            # decisions use day-d indicators, not a stale end-of-train view
            qa = [(QueryDate(idx=d, prices=data.prices[:d + 1]), data)
                  for d in range(t, hi)]
            sets.append((train, EmptyEvaluationInfo(), qa))
        return sets


# ---------------------------------------------------------------------------
# Regression strategy (RegressionStrategy.scala)
# ---------------------------------------------------------------------------

def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares answer of each system of a batch:
    a (batch, m, n), b (batch, m) -> x (batch, n), as ``jnp.linalg.lstsq``
    computes it with ``rcond=None``: ``x = V diag(1/s) U^T b`` over the
    singular values ``s >= eps * max(m, n) * s_max`` (and ``s > 0``), the
    rest dropped. ``eps`` is that of ``a``'s dtype."""
    m, n = a.shape[-2:]
    rcond = torch.tensor(torch.finfo(a.dtype).eps * max(m, n),
                         dtype=a.dtype, device=a.device)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = u.transpose(-1, -2) @ b[..., None]          # (batch, k, 1)
    return (vh.transpose(-1, -2) @ (s_inv[..., None] * utb))[..., 0]


@dataclass(frozen=True)
class RegressionStrategyParams(Params):
    shifts: Tuple[int, ...] = (1, 5, 22)    # ShiftsIndicator periods
    rsiPeriod: int = 14
    maxTrainingWindowSize: int = 200


@dataclass
class RegressionStrategyModel:
    tickers: List[str]
    coef: np.ndarray         # (tickers, n_features+1), intercept last
    prices: np.ndarray       # trailing window for query-time indicators
    active_ticker: np.ndarray  # (tickers,) bool — fully-active history


class RegressionStrategyAlgorithm(Algorithm):
    params_class = RegressionStrategyParams
    query_class = QueryDate

    def __init__(self, params: RegressionStrategyParams = None):
        self.sp = params or RegressionStrategyParams()

    def _indicators(self) -> List[BaseIndicator]:
        return ([ShiftsIndicator(p) for p in self.sp.shifts]
                + [RSIIndicator(self.sp.rsiPeriod)])

    def _features(self, log_price: np.ndarray) -> np.ndarray:
        """(days, tickers, n_ind) indicator tensor."""
        feats = [np.stack([ind.get_training(log_price[:, t])
                           for t in range(log_price.shape[1])], axis=1)
                 for ind in self._indicators()]
        return np.stack(feats, axis=-1)

    def train(self, ctx, data: StockTrainingData) -> RegressionStrategyModel:
        window = min(self.sp.maxTrainingWindowSize, data.prices.shape[0])
        prices = data.prices[-window:]
        active = data.active[-window:]
        log_price = np.log(np.where(prices > 0, prices, 1.0))
        feats = self._features(log_price)          # (days, tickers, n_ind)
        ret_f1 = np.zeros_like(log_price)
        ret_f1[:-1] = log_price[1:] - log_price[:-1]   # 1d forward return

        first = max(ind.min_window() for ind in self._indicators()) + 3
        last = log_price.shape[0] - 1               # last day has no target
        x = feats[first:last]                       # (T', tickers, n_ind)
        y = ret_f1[first:last]                      # (T', tickers)
        x = np.concatenate([x, np.ones((*x.shape[:2], 1))], axis=-1)

        # tickers with any inactive day are skipped (reference filters on
        # active.findOne(false) == -1)
        active_ticker = active.all(axis=0)

        # one batched least-squares over all tickers (vs the reference's
        # per-ticker breeze regress loop), in fp32 as the JAX package
        # solves it
        dev = device_mod.resolve(getattr(ctx, "device", None))
        xt = torch.as_tensor(np.swapaxes(x, 0, 1), dtype=torch.float32,
                             device=dev)            # (tickers, T', f)
        yt = torch.as_tensor(y.T, dtype=torch.float32,
                             device=dev)            # (tickers, T')
        coef = lstsq_min_norm(xt, yt).cpu().numpy()
        return RegressionStrategyModel(
            tickers=data.tickers, coef=coef, prices=prices,
            active_ticker=active_ticker)

    def predict(self, model: RegressionStrategyModel,
                query: QueryDate) -> StockPrediction:
        prices = query.prices if query.prices is not None else model.prices
        log_price = np.log(np.where(prices > 0, prices, 1.0))
        out: Dict[str, float] = {}
        inds = self._indicators()
        for t, ticker in enumerate(model.tickers):
            if not model.active_ticker[t]:
                continue
            feat = np.asarray([ind.get_one(log_price[:, t])
                               for ind in inds] + [1.0])
            out[ticker] = float(feat @ model.coef[t])
        return StockPrediction(data=out)


# ---------------------------------------------------------------------------
# Backtesting (BackTestingMetrics.scala)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BacktestingParams(Params):
    enterThreshold: float = 0.001
    exitThreshold: float = 0.0
    maxPositions: int = 3


@dataclass
class BacktestingResult:
    ret: float             # total return over the backtest
    vol: float             # stdev of daily NAV returns
    sharpe: float
    days: int
    nav: Tuple[float, ...] = field(default=(), repr=False)

    def __str__(self):
        return (f"BacktestingResult(ret={self.ret:.4f} vol={self.vol:.4f} "
                f"sharpe={self.sharpe:.2f} days={self.days})")


class BacktestingMetric(Metric):
    """Walk the daily enter/exit decisions and mark NAV to market
    (BacktestingEvaluator.evaluateAll). Queries must carry day indices;
    actuals the full price frame. Scores by Sharpe."""

    def __init__(self, params: BacktestingParams = None):
        self.bp = params or BacktestingParams()
        self.last_result: Optional[BacktestingResult] = None

    def calculate(self, eval_data_set) -> float:
        days: List[Tuple[int, StockPrediction, StockTrainingData]] = []
        for _ei, qpa in eval_data_set:
            for q, p, a in qpa:
                days.append((q.idx, p, a))
        days.sort(key=lambda d: d[0])
        if not days:
            return float("nan")
        frame = days[0][2]
        tix = {t: i for i, t in enumerate(frame.tickers)}

        init_cash = 1_000_000.0
        cash, positions = init_cash, {}     # ticker -> units
        last_good: Dict[str, float] = {}    # last tradeable price seen
        navs = [init_cash]

        def tradeable(t, day):
            # active mask + finite price: a delisted/missing-price day must
            # not divide into units or poison NAV
            return (bool(frame.active[day, tix[t]])
                    and np.isfinite(frame.prices[day, tix[t]])
                    and frame.prices[day, tix[t]] > 0)

        def mark(t, day):
            if tradeable(t, day):
                last_good[t] = float(frame.prices[day, tix[t]])
            return last_good[t]

        for idx, pred, _ in days:
            if idx + 1 >= frame.prices.shape[0]:
                break
            ranked = sorted(pred.data.items(), key=lambda kv: -kv[1])
            to_exit = [t for t, v in ranked if v <= self.bp.exitThreshold]
            to_enter = [t for t, v in ranked
                        if v >= self.bp.enterThreshold]
            for t in to_exit:
                if t in positions:
                    cash += positions.pop(t) * mark(t, idx)
            for t in to_enter:
                if len(positions) >= self.bp.maxPositions:
                    break
                if t not in positions and cash > 0 and tradeable(t, idx):
                    spend = cash / (self.bp.maxPositions - len(positions))
                    positions[t] = spend / mark(t, idx)
                    cash -= spend
            nav = cash + sum(u * mark(t, idx + 1)
                             for t, u in positions.items())
            navs.append(nav)
        navs_arr = np.asarray(navs)
        rets = np.diff(navs_arr) / navs_arr[:-1]
        vol = float(rets.std()) if rets.size else 0.0
        total = float(navs_arr[-1] / init_cash - 1.0)
        sharpe = float(rets.mean() / vol * np.sqrt(252)) if vol > 0 else 0.0
        self.last_result = BacktestingResult(
            ret=total, vol=vol, sharpe=sharpe, days=len(navs) - 1,
            nav=tuple(float(n) for n in navs))
        return sharpe


def engine() -> SimpleEngine:
    """scala-stock Run.scala role: datasource + regression strategy."""
    return SimpleEngine(StockDataSource, IdentityPreparator,
                        RegressionStrategyAlgorithm, FirstServing)
