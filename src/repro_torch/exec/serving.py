"""Batched CNN serving engine over the executor (PyTorch counterpart of
``repro.exec.serving``).

  * **batch buckets** — power-of-two batch sizes, each with its own
    ahead-of-time CnnPlan (scheduler.schedule_buckets on one shared plan
    cache).  A request is zero-padded up to the smallest bucket that fits
    and the results are sliced back; requests larger than the top bucket
    are chunked.  Zero padding is numerics-neutral: the per-tensor
    quantize scale is a max over |activations| and the padded images stay
    zero through every layer, so the real rows' logits are bitwise what an
    exact-size batch would produce.  (Chunking is not: each chunk is its
    own batch with its own quantize scale.);

  * **warmup()** — captures every bucket's forward in a CUDA graph with a
    dummy batch (``executor.compiled_logits``, one wrapper per bucket
    built up front: the walk and its logits, none of ``execute_cnn``'s
    per-GEMM fingerprints, which no request reads), so no request pays a
    capture or a kernel build (``stats()["retraces_since_warmup"]``
    stays 0); on the CPU it runs every bucket once;

  * a thread-safe **micro-batcher** — coalesces single-image requests
    from a queue into bucketed batches under a max-delay knob, resolving
    each request's Future with its row of the batched logits;

  * a **data-parallel path** over several device entries
    (``data_parallel=True, devices=[...]``, noise off): a bucket that the
    entries divide is split over them, shard i on entry i with its own
    parameter replica, and the shards walk the network in lockstep
    (``executor.sharded_forward``) so that every photonic GEMM quantizes
    with the whole batch's scale — the reference's GSPMD forward makes
    that max an all-reduce; the logits are concatenated back on the
    engine's device, BITWISE equal to one device's.  On the card each
    entry has CUDA graphs of its own for a bucket, one a segment between
    two GEMMs, and the batch's scale is reduced between segments.  The
    entries may repeat (replicas on the same card; the reference's Mesh
    refuses a repeated device, ROADMAP D11);

  * **serving metrics** — p50/p99 request latency, sustained throughput,
    padding-overhead fraction, plan-cache and compile-cache stats, and
    the photonic model's energy accounting of the served stream (modeled
    joules per inference, padding included, and sustained watts) from
    each bucket plan via core.hw.trace_energy.

Requests for one bucket share its graph's static buffers, so they
serialize on that graph's lock around copy-in, replay and clone-out
(``executor.CompiledForward``); requests for different buckets do not
wait for each other.

Noise: a noise-enabled engine requires a root seed per ``infer`` call
(per-chunk seeds are folded in, per-layer seeds inside the forward; the
noise is drawn outside the graph into its static buffers).

The data-parallel path is noise-off only, as the reference's: per-shard
noise streams would not reproduce the single-device stream.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hw
from repro_torch.core.photonic_gemm import fold_seed
from repro_torch.core.types import PhotonicConfig, resolve_device
from repro_torch.exec import executor as ex
from repro_torch.exec import plan_cache as pc
from repro_torch.exec.scheduler import CnnPlan, HardwareSpec, schedule_buckets
from repro_torch.models import cnn as cnn_mod
from repro_torch.runtime import trace

__all__ = ["ServingEngine", "MicroBatcher", "power_of_two_buckets",
           "bucket_for"]

#: How many recent request latencies the metrics window keeps.
_LATENCY_WINDOW = 16384


def power_of_two_buckets(max_batch: int) -> Tuple[int, ...]:
    """(1, 2, 4, ..., max_batch) with max_batch rounded UP to a power
    of two — a request never lands in a smaller bucket than itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets: List[int] = [1]
    while buckets[-1] < max_batch:
        buckets.append(buckets[-1] * 2)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending; n must fit the largest)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch {n} exceeds the largest bucket "
                     f"{buckets[-1]} — the engine chunks before bucketing, "
                     f"so this is an internal error")


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class ServingEngine:
    """Bucketed, warmed-up CNN serving on one device, or data-parallel
    over several device entries.

    One engine serves one network (lowering + params) on one accelerator
    config.  Entry points are thread-safe: concurrent request threads
    serialize on metrics bookkeeping and, per bucket, on its graph.

    Parameters
    ----------
    params, acc, cfg : the executor's weight dict, the hardware (an
        AcceleratorConfig, or — preferred — a core.hw.OperatingPoint, in
        which case ``cfg`` may be omitted and is derived via
        ``op.kernel_config()``), and the PhotonicConfig numerics.  A
        ``cfg`` that disagrees with the plans' hardware is rejected here.
    lowering : op-graph / legacy tuple; default small CNN.
    in_hw : input spatial size (int or (H, W)).
    max_batch : largest bucket (rounded up to a power of two).  Larger
        requests are chunked into top-bucket pieces.
    impl : 'auto' | 'kernel' | 'ref' (ops.photonic_matmul).
    plan_cache : shared PlanCache (fresh one per engine by default).
    data_parallel : split a bucket over ``devices`` (noise off; True
        with noise on raises).  Takes effect with more than one entry.
    devices : the data-parallel entries (default: every visible CUDA card,
        or ``[device]`` off the card); an entry may repeat.
    device : where to serve — the CUDA card unless the caller names
        another device (``device="cpu"`` runs the plain versions).
    """

    def __init__(self, params: dict, acc: HardwareSpec,
                 cfg: Optional[PhotonicConfig] = None, lowering=None,
                 in_hw=16, max_batch: int = 32, impl: str = "auto",
                 objective: str = "latency",
                 plan_cache: Optional[pc.PlanCache] = None,
                 data_parallel: bool = False, device=None,
                 devices: Optional[Sequence] = None) -> None:
        if cfg is None:
            if not isinstance(acc, hw.OperatingPoint):
                raise ValueError(
                    "cfg is required when acc is a bare AcceleratorConfig "
                    "— pass a PhotonicConfig, or hand the engine a "
                    "core.hw.OperatingPoint and let it derive the kernel "
                    "config coherently (op.kernel_config())")
            cfg = acc.kernel_config()
        self.device = resolve_device(device)
        self._params = {k: torch.as_tensor(v).to(self.device)
                        for k, v in params.items()}
        self._cfg = cfg
        self._impl = impl
        self._lowering = ex._norm_lowering(lowering)
        self._in_hw = ((in_hw, in_hw) if isinstance(in_hw, int)
                       else (int(in_hw[0]), int(in_hw[1])))
        self._in_ch = cnn_mod.as_graph(self._lowering,
                                       params=self._params).input.cout
        self.buckets = power_of_two_buckets(max_batch)
        self.plan_cache = (plan_cache if plan_cache is not None
                           else pc.PlanCache())
        gemms = cnn_mod.lowered_gemms(self._params, self._lowering,
                                      self._in_hw)
        self.plans: Dict[int, CnnPlan] = schedule_buckets(
            gemms, acc, self.buckets, objective, cache=self.plan_cache)
        # Every bucket shares one hardware spec, so checking one plan
        # pins cfg against all of them (the executor re-checks per batch).
        hw.check_kernel_plan_coherence(cfg, self.plans[self.buckets[0]])
        # One compiled wrapper per bucket, built up front; the graphs are
        # captured at warmup() or first call.
        self._fns = {b: ex.compiled_logits(self.plans[b], cfg,
                                           self._lowering, impl)
                     for b in self.buckets}

        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        self.devices = [resolve_device(d) for d in devices]
        self.data_parallel = bool(data_parallel) and len(self.devices) > 1
        if bool(data_parallel) and cfg.noise_enabled:
            raise ValueError(
                "data_parallel serving requires noise_enabled=False — "
                "per-shard noise streams would not reproduce the "
                "single-device stream (run noisy inference single-device)")
        if self.data_parallel:
            self._params_dp = [{k: v.to(d, copy=True)
                                for k, v in self._params.items()}
                               for d in self.devices]
            self._dp_fns = {b: ex.sharded_forward(self.plans[b], cfg,
                                                  self._lowering, impl)
                            for b in self.buckets if self._dp_bucket(b)}

        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._requests = 0
        self._images = 0
        self._blocked_images = 0
        self._batches = 0
        self._padded_slots = 0
        self._executed_slots = 0
        # Wall time in which at least one blocking request was in flight
        # (closed stretches; stats() adds the open one).
        self._busy_s = 0.0
        self._in_flight = 0
        self._flight_t0 = 0.0
        self._warm = False
        self._retraces = 0
        # Modeled photonic energy of the executed stream, per bucket from
        # the plans; a padded bucket is charged in full.
        self._bucket_energy = {b: hw.trace_energy(self.plans[b])
                               for b in self.buckets}
        self._energy_j = 0.0
        self._model_time_s = 0.0

    # -- bucket plumbing -----------------------------------------------------
    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def _sync(self) -> None:
        for d in {self.device, *(self.devices if self.data_parallel
                                 else ())}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _dp_bucket(self, bucket: int) -> bool:
        return self.data_parallel and bucket % len(self.devices) == 0

    def _run_bucket(self, xb: torch.Tensor, seed: Optional[int],
                    bucket: int) -> torch.Tensor:
        traces0 = ex.trace_count() if self._warm else 0
        if self._dp_bucket(bucket):
            with trace.span("serving.scatter"):
                xs = [c.to(d) for c, d in zip(xb.chunk(len(self.devices)),
                                              self.devices)]
            outs = self._dp_fns[bucket](self._params_dp, xs)
            with trace.span("serving.gather"):
                logits = torch.cat([o.to(self.device) for o in outs])
        else:
            logits = self._fns[bucket](self._params, xb, seed)
        if self._warm:
            # Engine-local retrace accounting: only captures across THIS
            # engine's calls count, not another engine's warmup.
            traced = ex.trace_count() - traces0
            if traced:
                with self._lock:
                    self._retraces += traced
        return logits

    def _infer_chunk(self, chunk: torch.Tensor,
                     seed: Optional[int]) -> torch.Tensor:
        n = chunk.shape[0]
        bucket = bucket_for(n, self.buckets)
        pad = bucket - n
        xb = chunk
        if pad:
            with trace.span("serving.pad"):
                xb = torch.cat([chunk, chunk.new_zeros(
                    (pad,) + tuple(chunk.shape[1:]))])
        with trace.span("serving.validate"):
            ex._validate(xb, self.plans[bucket], self._cfg, self._lowering,
                         seed)
        logits = self._run_bucket(xb, seed, bucket)
        te = self._bucket_energy[bucket]
        with self._lock:
            self._batches += 1
            self._padded_slots += pad
            self._executed_slots += bucket
            self._energy_j += te.energy_j
            self._model_time_s += te.latency_s
        return logits[:n] if pad else logits

    # -- public entry points -------------------------------------------------
    def warmup(self, seed: Optional[int] = None) -> Dict[int, float]:
        """Capture every bucket's forward with a dummy batch (on the CPU:
        run it once), so no request pays a capture or a kernel build.
        Returns {bucket: cold_seconds}.  With noise enabled a dummy seed is
        used; serving seeds replay the same graph."""
        if not self._cfg.noise_enabled:
            seed = None
        elif seed is None:
            seed = 0
        h, w = self._in_hw
        cold: Dict[int, float] = {}
        for b in self.buckets:
            x = torch.zeros((b, h, w, self._in_ch), dtype=torch.float32,
                            device=self.device)
            t0 = time.perf_counter()
            self._run_bucket(x, seed, b)
            self._sync()
            cold[b] = time.perf_counter() - t0
        with self._lock:
            self._warm = True
            self._retraces = 0
        return cold

    def infer(self, x, seed: Optional[int] = None,
              block: bool = True) -> torch.Tensor:
        """Serve one request: (N, H, W, C) images -> (N, classes) logits.

        N is arbitrary: it is padded up to the smallest bucket that fits
        (chunked into top-bucket pieces first if N > max_bucket; with a
        seed, each chunk folds in its index).  ``block=True`` waits for
        the device so the recorded latency is true request latency;
        ``block=False`` returns as soon as the work is queued — such calls
        count toward request/image/padding totals but not toward the
        latency percentiles or sustained_ips.
        """
        t0 = time.perf_counter()
        x = torch.as_tensor(x)
        if x.dim() != 4:
            raise ValueError(f"x must be (N, H, W, C) images, got shape "
                             f"{tuple(x.shape)} — for a single image use "
                             f"infer_one or x[None]")
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty request: x has batch 0")
        if not self._cfg.noise_enabled:
            seed = None
        n_chunks = -(-n // self.max_bucket)
        if block:
            with self._lock:
                if not self._in_flight:
                    self._flight_t0 = t0
                self._in_flight += 1
        done = False
        try:
            with trace.request("serving.infer", n, n_chunks):
                x = x.to(device=self.device, dtype=torch.float32)
                outs: List[torch.Tensor] = []
                start, ci = 0, 0
                while start < n:
                    take = min(self.max_bucket, n - start)
                    cs = (fold_seed(seed, ci)
                          if seed is not None and n_chunks > 1 else seed)
                    outs.append(self._infer_chunk(x[start:start + take], cs))
                    start += take
                    ci += 1
                logits = outs[0] if len(outs) == 1 else torch.cat(outs)
                if block:
                    with trace.span("serving.sync"):
                        self._sync()
                done = True
        finally:
            t1 = time.perf_counter()
            with self._lock:
                if block:
                    self._in_flight -= 1
                    if not self._in_flight:
                        self._busy_s += t1 - self._flight_t0
                if done:
                    self._requests += 1
                    self._images += n
                    if block:
                        self._blocked_images += n
                        self._latencies.append(t1 - t0)
                        if len(self._latencies) > _LATENCY_WINDOW:
                            del self._latencies[:-_LATENCY_WINDOW]
        return logits

    def infer_one(self, image, seed: Optional[int] = None) -> torch.Tensor:
        """Serve a single (H, W, C) image -> (classes,) logits."""
        image = torch.as_tensor(image)
        if image.dim() != 3:
            raise ValueError(f"image must be (H, W, C), got shape "
                             f"{tuple(image.shape)}")
        return self.infer(image[None], seed=seed)[0]

    def stats(self) -> dict:
        """Serving metrics + the cache and capture hooks."""
        now = time.perf_counter()
        with self._lock:
            lat = sorted(self._latencies)
            busy = self._busy_s + (now - self._flight_t0
                                   if self._in_flight else 0.0)
            warm = self._warm
            retraces = self._retraces
            out = {
                "requests": self._requests,
                "images": self._images,
                "batches": self._batches,
                "padded_slots": self._padded_slots,
                "executed_slots": self._executed_slots,
                "padding_fraction": (
                    self._padded_slots / self._executed_slots
                    if self._executed_slots else 0.0),
                "latency_p50_s": _percentile(lat, 0.50),
                "latency_p99_s": _percentile(lat, 0.99),
                "latency_mean_s": (sum(lat) / len(lat)) if lat else 0.0,
                # Images of blocking requests over the wall time in which
                # at least one was in flight (concurrent requests overlap).
                "sustained_ips": (self._blocked_images / busy
                                  if busy > 0 else 0.0),
                "buckets": list(self.buckets),
                "data_parallel": self.data_parallel,
                "n_devices": len(self.devices),
                "device": str(self.device),
                "warmed_up": warm,
                # Photonic-model energy of the served stream (not the
                # host's or the card's electricity): joules per real
                # inference, padding included, and the accelerator's
                # sustained draw over the modeled busy time.
                "modeled_energy_j": self._energy_j,
                "modeled_j_per_image": (self._energy_j / self._images
                                        if self._images else 0.0),
                "modeled_sustained_w": (self._energy_j / self._model_time_s
                                        if self._model_time_s > 0 else 0.0),
            }
        out["retraces_since_warmup"] = retraces if warm else None
        out["plan_cache"] = self.plan_cache.stats()
        out["compile_cache"] = ex.compile_cache_stats()
        return out


class MicroBatcher:
    """Thread-safe request coalescer: single images in, bucketed batches
    through a ServingEngine, per-request Futures out.

    A background worker takes the first queued request, then keeps
    gathering until either ``max_batch`` requests are in hand or
    ``max_delay_s`` has elapsed since the first one — the classic
    latency/throughput knob.  The stacked batch goes through
    ``engine.infer`` (which pads it to a bucket), and each Future
    resolves with its own row of the logits.

    With a noise-enabled engine pass a root ``seed``: each formed batch
    folds in a monotonic counter (``fold_seed``), so batches draw
    independent noise and a given (seed, arrival order) replays exactly.
    """

    def __init__(self, engine: ServingEngine, max_delay_s: float = 0.002,
                 max_batch: Optional[int] = None,
                 seed: Optional[int] = None) -> None:
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self._engine = engine
        self._max_delay_s = float(max_delay_s)
        self._max_batch = int(max_batch or engine.max_bucket)
        if self._max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if engine._cfg.noise_enabled and seed is None:
            raise ValueError(
                "engine has noise_enabled=True: MicroBatcher needs a root "
                "seed (per-batch seeds are folded in)")
        self._seed = seed
        self._batch_counter = 0
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._batches_formed = 0
        self._requests_batched = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            raise RuntimeError("MicroBatcher already started")
        self._thread = threading.Thread(target=self._run,
                                        name="micro-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        """Stop the worker after draining already-queued requests.

        A submit() that passed its stopped-check concurrently with this
        call may enqueue after the worker exits; the drain below picks
        such stragglers up so no accepted Future is left unresolved.
        """
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self._drain_now()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path --------------------------------------------------------
    def submit(self, image) -> "Future":
        """Enqueue one (H, W, C) image; the Future resolves to its
        (classes,) logits (or raises what the engine raised)."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is stopped")
        image = torch.as_tensor(image)
        if image.dim() != 3:
            raise ValueError(f"image must be (H, W, C), got shape "
                             f"{tuple(image.shape)}")
        fut: Future = Future()
        self._queue.put((image, fut))
        return fut

    def _next_seed(self) -> Optional[int]:
        if self._seed is None:
            return None
        s = fold_seed(self._seed, self._batch_counter)
        self._batch_counter += 1
        return s

    def _drain_now(self) -> None:
        """Dispatch everything currently queued, in bucket-size groups
        (queue.get is atomic, so a concurrent worker and a draining
        stop() cannot double-dispatch a request)."""
        while True:
            group: list = []
            while len(group) < self._max_batch:
                try:
                    group.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if not group:
                return
            self._dispatch(group)

    def _run(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.02)
            except queue.Empty:
                if self._stop.is_set():
                    self._drain_now()      # requests that raced the stop
                    return
                continue
            batch = [first]
            deadline = time.perf_counter() + self._max_delay_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        try:
            # stack is inside the guard: mixed image shapes in one
            # coalescing window must fail THESE futures, not kill the
            # worker thread (which would hang every later request).
            images = torch.stack([b[0] for b in batch])
            logits = self._engine.infer(images, seed=self._next_seed())
        except Exception as exc:  # surface engine errors per request
            for _, fut in batch:
                fut.set_exception(exc)
            return
        for i, (_, fut) in enumerate(batch):
            fut.set_result(logits[i])
        with self._lock:
            self._batches_formed += 1
            self._requests_batched += len(batch)

    def stats(self) -> dict:
        with self._lock:
            formed = self._batches_formed
            n = self._requests_batched
        return {"batches_formed": formed, "requests_batched": n,
                "mean_fill": (n / formed) if formed else 0.0,
                "max_delay_s": self._max_delay_s,
                "max_batch": self._max_batch,
                "queued": self._queue.qsize()}

