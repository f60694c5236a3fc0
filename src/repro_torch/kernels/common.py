"""The launch-plan autotuner and the tiling helpers, PyTorch port of
``repro.kernels.common``.

A kernel whose launch has several valid plans (``round_step``: the tile,
the lane vector and the stages of its copy ring) lists them, its heuristic
default first, and asks :func:`tuned_block`, which resolves, in order:
process memo → on-disk cache → (only when ``REPRO_AUTOTUNE=1``) timing each
candidate on the live shapes. There is no interpret mode to key: a kernel
wrapper given a CPU tensor runs its plain PyTorch version and asks for no
plan, so only card launches are tuned, and :func:`backend_key` names the
card (name and compute capability) so that two cards never share a winner.

Modes (``REPRO_AUTOTUNE``):
  unset  → "cache": a cached winner if one exists, else the default — never
           spends time measuring;
  1/on   → "tune": a cache miss times every candidate and persists the
           winner;
  0/off  → "off": ignore the cache, always the default.

The cache is a JSON file, ``REPRO_AUTOTUNE_CACHE`` or
``$XDG_CACHE_HOME/repro-crdt-torch/autotune.json`` (``~/.cache`` without
``XDG_CACHE_HOME``): never the JAX package's file, whose keys name other
backends.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import time

import torch

DEFAULT_BLOCK = (512, 1024)

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

_TUNE_MEM: dict = {}
_FILE_MEM: dict = {}        # (path, mtime, size) -> parsed cache


@functools.lru_cache(maxsize=None)
def _card_key(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda-{torch.cuda.get_device_name(index)}-sm{major}{minor}"


def backend_key(device) -> str:
    """Autotune cache namespace: ``"cpu"`` for the CPU, else
    ``"cuda-<device name>-sm<major><minor>"`` of the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _card_key(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def autotune_mode() -> str:
    v = os.environ.get("REPRO_AUTOTUNE", "").strip().lower()
    if v in _FALSE:
        return "off"
    if v in _TRUE or v == "tune":
        return "tune"
    return "cache"


def autotune_cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE", "").strip()
    if env:
        return pathlib.Path(env)
    root = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return pathlib.Path(root) / "repro-crdt-torch" / "autotune.json"


def shape_bucket(n: int) -> int:
    """Next power of two ≥ n (≥ 1): the shape granularity of cache keys."""
    return 1 << max(0, int(n - 1).bit_length())


def _load_tune_cache(path: pathlib.Path) -> dict:
    """The parsed cache file, or {} if it is missing or corrupt. A file
    parsed once is kept by (path, mtime, size), so a launch that resolves
    its plan costs one ``stat`` while the file is unchanged."""
    try:
        st = os.stat(path)
    except OSError:
        return {}
    mem = (str(path), st.st_mtime_ns, st.st_size)
    if mem not in _FILE_MEM:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            # corrupt cache → retune/default; never crash the caller
            data = {}
        _FILE_MEM[mem] = data if isinstance(data, dict) else {}
    return dict(_FILE_MEM[mem])


def _store_tune_cache(path: pathlib.Path, cache: dict) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                    # read-only FS: tuning still works, untracked


def tuned_block(family: str, key_parts, candidates, bench=None, *,
                mode: str | None = None, timer=time.perf_counter,
                reps: int = 2, warmup: int = 1, cache_path=None):
    """Resolve the launch config for one kernel-family call site.

    ``candidates``: non-empty list of config tuples, first = heuristic
    default. ``bench(config)``: runs the kernel with that config; only
    invoked in "tune" mode, between two calls of ``timer`` (a card's bench
    times with :func:`event_timer`). ``timer``/``reps``/``warmup``/
    ``cache_path``/``mode`` are injectable for tests. Returns
    ``(config, source)`` with source one of "default" | "cache" | "tuned".
    A candidate whose bench raises is skipped; a cached config that is no
    longer a candidate is ignored.
    """
    candidates = [tuple(c) for c in candidates]
    default = candidates[0]
    mode = autotune_mode() if mode is None else mode
    if mode == "off" or len(candidates) == 1:
        return default, "default"
    path = pathlib.Path(cache_path) if cache_path is not None \
        else autotune_cache_path()
    key = "|".join((family,) + tuple(str(p) for p in key_parts))
    memo_key = (str(path), key)
    if memo_key in _TUNE_MEM:
        return _TUNE_MEM[memo_key], "cache"
    cache = _load_tune_cache(path)
    ent = cache.get(key)
    if isinstance(ent, dict):
        try:
            cfg = tuple(int(v) for v in ent["config"])
        except (KeyError, TypeError, ValueError):
            cfg = None             # corrupt entry → fall through
        if cfg in candidates:
            _TUNE_MEM[memo_key] = cfg
            return cfg, "cache"
    if mode != "tune" or bench is None:
        return default, "default"
    best, best_t = default, float("inf")
    timings = {}
    for cand in candidates:
        try:
            for _ in range(warmup):
                bench(cand)
            ts = []
            for _ in range(reps):
                t0 = timer()
                bench(cand)
                ts.append(timer() - t0)
        except Exception:          # noqa: BLE001 — unlaunchable candidate
            continue
        t = min(ts)
        timings[str(list(cand))] = t
        if t < best_t:
            best, best_t = cand, t
    cache[key] = {"config": list(best), "timings_s": timings}
    _store_tune_cache(path, cache)
    _TUNE_MEM[memo_key] = best
    return best, "tuned"


def event_timer(device):
    """A ``timer`` for :func:`tuned_block` on a card: each call records a
    CUDA event on the device's current stream, waits for it and returns
    the seconds since the first call, so the difference of two calls is
    the device time of the work queued between them."""
    dev = torch.device(device)
    start = []

    def timer() -> float:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
        if not start:
            start.append(ev)
        return start[0].elapsed_time(ev) / 1e3

    return timer


def pad_to_2d(x: torch.Tensor, block=DEFAULT_BLOCK):
    """Flatten to 1D, pad with zeros (⊥ of every value lattice used), and
    reshape to [M, N] whole tiles. Returns (x2d, orig_shape, valid_len)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1)
    n = flat.shape[0]
    bm, bn = block
    rows = -(-n // bn)
    rows_pad = -(-rows // bm) * bm
    flat = torch.nn.functional.pad(flat, (0, rows_pad * bn - n))
    return flat.reshape(rows_pad, bn), shape, n


def unpad_from_2d(x2d: torch.Tensor, shape, n):
    return x2d.reshape(-1)[:n].reshape(shape)


def grid_for(shape_2d, block=DEFAULT_BLOCK):
    m, n = shape_2d
    bm, bn = block
    return (-(-m // bm), -(-n // bn))
