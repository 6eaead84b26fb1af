"""Serving layer: the Espresso prediction-phase engine on the port.

:class:`PackedInferenceServer` is the packed half of the reference's
``src/repro/train/serve.py`` (``:47–871``) on the port's forwards: a
forward-only engine over the packed BCNN, BMLP and binary-LM networks
(``models/cnn.py``, ``models/transformer.py``) with a continuous-batching
request queue (admit/evict per step, deadline-aware flush, no
head-of-line blocking on ragged arrivals), a packed weight cache keyed by
model config (pack + fold BN thresholds ONCE, paper C2, reused across
requests), and a staging pool so steady-state serving allocates no
per-flush host buffer.  Every flush runs the port's hand-written kernels
through ``models.cnn.make_packed_forward`` on the server's device, and
records the K4 route its bucket takes (``kernels.ops.dispatch_batch``).

What differs from the reference, and why:

* **An explicit device.** ``PackedInferenceServer(device="cuda")`` packs
  on that device and raises without a card; tests pass ``device="cpu"``.
  Nothing falls back to the CPU.
* **The engine's own input dtype.** Staging buffers are keyed on it:
  uint8 for the BCNN's and BMLP's images, and for the LM an integer type
  that holds every id of its vocab.  (The reference stages every cohort
  in uint8, so LM token ids >= 256 wrap.)  ``submit`` rejects an input
  of the wrong shape, a non-integer type or a value out of range before
  admitting it.
* **Results** are rows of a CPU tensor: the forward's output is copied
  to the host once per flush, and that copy is where ``serve.compute``
  blocks on the device work.
* **A mesh behind the queue** (``mesh=``) is a ``launch.mesh.Mesh``
  driven from this process (``distributed.sharding``); its positions may
  share one card.

The LM decode server of the model zoo (the reference's ``:878-1002``):
:func:`make_prefill_step`, :func:`make_decode_step`, :class:`Request` and
:class:`BatchedServer`, a slot ring over ``models.model.decode_step``
with the reference's semantics (prompts teacher-forced through the
decode path, freed slots zeroed, truncation when the cache runs out, one
global decode mask).  The step runs eagerly where the reference jits it,
and writes each token's K/V and state into the server's one cache in
place where the reference's jit donates the buffer.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cnn as C
from repro_torch.models import model as M
from repro_torch.models.cnn import _check_device
from repro_torch.tree import leaves_with_path, tree_map
from repro_torch.telemetry import MetricsRegistry, Telemetry

class BackpressureError(RuntimeError):
    """Typed admission shed: the queue is full, the request was NEVER
    admitted (no rid) — the caller sheds or retries later.  Subclasses
    ``RuntimeError`` so callers that catch the untyped backpressure
    signal keep working."""


class DeviceLossError(RuntimeError):
    """A device backing the active engine disappeared mid-flush.

    NOT batch-local: retrying or bisecting the batch cannot help when
    the hardware under the forward is gone, so the server requeues the
    in-flight window (zero requests lost) and re-raises for the caller
    to rebuild the engine (:meth:`PackedInferenceServer.rebuild_engine`)
    on what survives.
    """

    def __init__(self, survivors: int, msg: str | None = None):
        super().__init__(msg or f"device lost; {survivors} survivor(s)")
        self.survivors = survivors


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for failing flushes.

    A cohort gets ``1 + max_retries`` dispatch attempts; the k-th retry
    sleeps ``min(max_backoff_s, backoff_base_s * backoff_factor**(k-1))``
    first.  Once the budget is spent a multi-request cohort BISECTS —
    each half gets a fresh budget — so one poison request cannot
    repeatedly kill whole cohorts: bisection isolates it in
    ``O(log batch)`` dispatches and only the singleton completes as
    ``error``.  ``DeviceLossError`` is never retried here (it is not a
    batch-local fault; see its docstring).
    """
    max_retries: int = 2
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0
    max_backoff_s: float = 0.250

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based), capped."""
        return min(self.max_backoff_s,
                   self.backoff_base_s * self.backoff_factor
                   ** (attempt - 1))


#: Terminal request states (exactly one per admitted request):
#: served (``ok``), deadline exceeded past the grace factor
#: (``timeout``), flush failed after retries + bisection (``error``).
#: The fourth lifecycle outcome, ``shed``, never gets a rid — ``submit``
#: raises :class:`BackpressureError` before admission.
TERMINAL_STATES = ("ok", "timeout", "error")


@dataclasses.dataclass
class ServeRequest:
    """One forward request in the continuous-batching queue.

    ``x`` is a single example as the engine takes it: a CPU tensor of
    shape ``models.cnn.packed_input_shape`` in the engine's input dtype;
    ``deadline`` is the absolute clock time by which the request must be
    flushed even if the batch is not full.  ``status`` moves ``pending``
    → exactly one of :data:`TERMINAL_STATES`; ``result`` (a row of the
    flush's output on the host) and ``completed_at`` are filled at
    completion (``result`` stays None and ``error`` carries the exception
    for non-``ok`` outcomes).
    """
    rid: int
    x: Any
    deadline: float
    submitted_at: float
    status: str = "pending"
    error: BaseException | None = None
    result: torch.Tensor | None = None
    completed_at: float | None = None
    # tracer-clock stamp (perf_counter_ns) taken at submit when tracing
    # is enabled — the queue-wait span's start point.  The serving clock
    # may be simulated (SimClock), so it cannot anchor trace timestamps.
    trace_submit_ns: int | None = None

    @property
    def latency(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    """Per-flush bookkeeping: how many real requests rode which bucket
    through which K4 route (``route`` ∈ {'gemv', 'gemm'}), and how many
    retry attempts the dispatch needed (0 on the healthy path)."""
    batch: int
    bucket: int
    route: str
    at: float
    wall_s: float
    retries: int = 0


class PackedModelCache:
    """Pack/fold-once cache keyed by model config (paper C2).

    ``get_or_pack(key, pack_fn)`` returns the cached packed tree for
    ``key`` or calls ``pack_fn()`` exactly once and caches the result —
    re-registering a config the server has already seen (including
    after swapping to a different model and back) never re-packs
    weights or re-folds BN thresholds.  ``invalidate(key)`` drops an
    entry when its underlying parameters changed (the ONLY correct
    response to a weight update — packed trees are derived data).
    Hit/miss/invalidation counts live in a telemetry metrics registry
    (``serve.cache.*`` — pass the server's via ``metrics=``, or a fresh
    one is created); ``hits``/``misses`` remain as read-only views.
    """

    def __init__(self, metrics: MetricsRegistry | None = None):
        self._entries: dict[Any, Any] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._hits = self.metrics.counter("serve.cache.hits")
        self._misses = self.metrics.counter("serve.cache.misses")
        self._invalidations = self.metrics.counter(
            "serve.cache.invalidations")

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    def get_or_pack(self, key, pack_fn: Callable[[], Any]):
        if key in self._entries:
            self._hits.inc()
        else:
            self._misses.inc()
            self._entries[key] = pack_fn()
        return self._entries[key]

    def invalidate(self, key) -> bool:
        """Drop ``key``; True if it was cached."""
        dropped = self._entries.pop(key, None) is not None
        if dropped:
            self._invalidations.inc()
        return dropped

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class ActivationPool:
    """Reusable host staging buffers, one per (bucket, example shape,
    dtype).

    Steady-state serving writes every flush into the same preallocated
    CPU tensor — ``allocations`` stops growing once all buckets are warm,
    so the request path allocates no staging buffer per flush.  The
    forward copies the buffer to the device in one transfer; inter-stage
    activations never appear here: they stay bit-packed on the device
    inside the forward.  There is no default dtype: the engine names its
    own (:class:`_Engine`), so a token id is never narrowed to a byte.

    Buffer accounting lives in a telemetry metrics registry
    (``serve.pool.allocations`` / ``serve.pool.reuses`` — pass the
    server's via ``metrics=``); ``allocations`` remains a read-only view.
    """

    def __init__(self, metrics: MetricsRegistry | None = None):
        self._bufs: dict[tuple, torch.Tensor] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._allocations = self.metrics.counter("serve.pool.allocations")
        self._reuses = self.metrics.counter("serve.pool.reuses")

    @property
    def allocations(self) -> int:
        return self._allocations.value

    def batch_buffer(self, bucket: int, example_shape: tuple[int, ...],
                     dtype: torch.dtype) -> torch.Tensor:
        key = (bucket, tuple(example_shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            self._allocations.inc()
            buf = torch.zeros((bucket, *example_shape), dtype=dtype)
            self._bufs[key] = buf
        else:
            self._reuses.inc()
        return buf


@dataclasses.dataclass
class _Engine:
    """One registered model: its packed tree + forward + the static facts
    the queue needs to stage, size and route flushes.  ``input_dtype``
    holds every valid input value, which lies in ``[0, input_limit)``:
    a pixel (uint8, 256) or a token id (the vocab).  Every bucket is a
    multiple of ``batch_multiple`` (the mesh's data size, 1 without a
    mesh)."""
    kind: str
    packed: Any
    fwd: Callable[[Any], torch.Tensor]
    example_shape: tuple[int, ...]
    input_dtype: torch.dtype
    input_limit: int
    kw_words: int
    batch_multiple: int
    buckets: tuple[int, ...]


def _default_buckets(max_batch: int) -> tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def _input_type(packed: dict) -> tuple[torch.dtype, int]:
    """(dtype, exclusive upper bound) of a packed network's input values:
    uint8 pixels for the BCNN and BMLP; for the LM token ids below its
    vocab, in uint8 only where the vocab fits a byte, else int32."""
    if C.packed_kind(packed) != "transformer":
        return torch.uint8, 256
    vocab = int(packed["meta"]["vocab_size"])
    return (torch.uint8 if vocab <= 256 else torch.int32), vocab


def _as_input(eng: _Engine, x) -> torch.Tensor:
    """One example as the engine takes it: a CPU tensor of the engine's
    shape and input dtype.  Raises ``ValueError`` for another shape, a
    non-integer type or a value outside ``[0, input_limit)``, so nothing
    is narrowed when it is staged."""
    t = torch.as_tensor(x)
    if tuple(t.shape) != eng.example_shape:
        raise ValueError(f"expected an example of shape {eng.example_shape},"
                         f" got {tuple(t.shape)}")
    if t.dtype.is_floating_point or t.dtype.is_complex or \
            t.dtype == torch.bool:
        raise ValueError(f"expected integer inputs, got {t.dtype}")
    t = t.cpu()
    # widened, since torch has no min/max for uint16/32/64 (uint64 past
    # 2**63 wraps negative here, and is refused)
    wide = t.to(torch.int64)
    lo, hi = int(wide.min()), int(wide.max())
    if lo < 0 or hi >= eng.input_limit:
        raise ValueError(f"{eng.kind} inputs must lie in [0, "
                         f"{eng.input_limit}), got [{lo}, {hi}]")
    return t.to(eng.input_dtype)


class PackedInferenceServer:
    """Continuous-batching server over the port's packed forwards.

    Queue lifecycle: ``submit`` admits a request FIFO with an absolute
    flush ``deadline``; every ``step`` flushes (a) all full ``max_batch``
    windows and (b) — once the OLDEST pending deadline has expired —
    everything still queued, padded up to the smallest bucket that holds
    it.  Arrivals after a flush started simply ride the next one, so a
    ragged arrival can neither block earlier requests (they flush on
    their own deadline) nor be blocked by them (the deadline flush takes
    the whole queue, not just the expired prefix).  ``cancel`` evicts a
    queued request; ``max_queue`` bounds admission (``submit`` raises
    :class:`BackpressureError` when full — the backpressure seam).

    Batches are padded to power-of-two buckets; padded rows are zeros
    (rewritten on every flush) and their outputs are discarded.  Every
    step after the integer dots works row by row, so a served row equals
    the direct ``make_packed_forward`` call on the unpadded batch exactly
    (``tests/test_torch_serve.py``).  Flushes whose bucket is at most
    ``binary_matmul.SMALL_M_MAX`` rows take K4's XOR + POPC kernel
    ('gemv'), larger ones its tensor-core kernel ('gemm') — the
    ``kernels.ops.dispatch_batch`` rule, recorded per flush in
    ``flushes``.

    Fault tolerance: every admitted request reaches exactly ONE terminal
    state (:data:`TERMINAL_STATES`).  A flush that raises fails only its
    own window — it is retried under the bounded-backoff
    :class:`RetryPolicy` and then bisected so a poison request errors
    alone while its cohort is served; a request whose deadline is
    exceeded by more than ``timeout_grace`` × its deadline budget
    completes as ``timeout`` instead of being served stale
    (``timeout_grace=None``, the default, never times out — deadlines
    then only drive flush scheduling); a full queue sheds with
    :class:`BackpressureError`.  ``flush_hook`` is the fault-injection
    seam (``runtime.faults.FaultInjector``) wrapping the device dispatch
    of ``_flush_window``; on :class:`DeviceLossError` the window is
    requeued and the error propagates to the caller, which can rebuild
    the engine via :meth:`rebuild_engine`.

    ``device`` is where models are packed and run: the card by default,
    and without one the constructor raises.
    """

    def __init__(self, *, max_batch: int = 32,
                 buckets: tuple[int, ...] | None = None,
                 default_deadline: float = 0.010,
                 max_queue: int | None = None,
                 completed_mailbox: int = 1024,
                 clock: Callable[[], float] = time.monotonic,
                 retry: RetryPolicy | None = None,
                 timeout_grace: float | None = None,
                 sleep: Callable[[float], Any] | None = None,
                 telemetry: Telemetry | None = None,
                 device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        device = _check_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.max_batch = max_batch
        self._bucket_template = (tuple(sorted(set(buckets)))
                                 if buckets else _default_buckets(max_batch))
        if self._bucket_template[-1] < max_batch:
            raise ValueError(
                f"largest bucket {self._bucket_template[-1]} smaller than "
                f"max_batch {max_batch}")
        self.default_deadline = default_deadline
        self.max_queue = max_queue
        self._clock = clock
        self.retry = retry if retry is not None else RetryPolicy()
        if timeout_grace is not None and timeout_grace < 1.0:
            raise ValueError(
                f"timeout_grace must be >= 1 (a multiple of the deadline "
                f"budget) or None, got {timeout_grace}")
        self.timeout_grace = timeout_grace
        # Backoff sleeps must not stall a simulated clock forever: when
        # the injected clock can advance (SimClock), sleeping IS
        # advancing it, so retry/backoff stays deterministic in tests.
        if sleep is not None:
            self._sleep = sleep
        elif callable(getattr(clock, "advance", None)):
            self._sleep = clock.advance
        else:
            self._sleep = time.sleep
        # The fault-injection seam: when set, `_flush_window` routes its
        # device dispatch through `flush_hook(eng, buf, reqs, default)`
        # instead of calling `default()` (= `eng.fwd(buf)`) directly.
        # `runtime.faults.FaultInjector.attach` installs itself here.
        self.flush_hook: Callable[..., Any] | None = None
        # Per-server telemetry (isolated; tracing off by default — the
        # disabled span path is one attribute check).  The cache and
        # pool write their counters into the SAME registry, so one
        # snapshot carries the whole serve.* taxonomy.
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        m = self.telemetry.metrics
        self._m_submitted = m.counter("serve.submitted")
        self._m_completed = m.counter("serve.completed")
        self._m_cancelled = m.counter("serve.cancelled")
        self._m_rejected = m.counter("serve.rejected")
        self._m_flushes = m.counter("serve.flushes")
        self._m_errors = m.counter("serve.errors")
        self._m_retries = m.counter("serve.retries")
        self._m_timeouts = m.counter("serve.timeouts")
        self._m_shed = m.counter("serve.shed")
        self._m_bisections = m.counter("serve.bisections")
        self._m_padded = m.counter("serve.padded_rows")
        self._m_routes = {r: m.counter(f"serve.route.{r}")
                          for r in ("gemv", "gemm")}
        self._m_depth = m.gauge("serve.queue_depth")
        self._h_latency = m.histogram("serve.request_latency_s")
        self._h_wait = m.histogram("serve.queue_wait_s")
        self._h_flush = m.histogram("serve.flush_wall_s")
        self.cache = PackedModelCache(metrics=m)
        self.pool = ActivationPool(metrics=m)
        self._engines: dict[Any, _Engine] = {}
        self._active: Any = None
        self._queue: collections.deque[ServeRequest] = collections.deque()
        # rid -> completed request, claimable via take(); bounded FIFO so
        # callers that consume step()/flush() returns directly (and never
        # claim) cannot leak the mailbox.  served/flushes are bounded the
        # same way — they are observability history, and an unbounded
        # list of requests (each holding its input and result row) would
        # be a steady-state leak in a long-running server.
        self._completed: collections.OrderedDict[int, ServeRequest] = \
            collections.OrderedDict()
        self._completed_cap = max(completed_mailbox, 2 * max_batch)
        self._next_rid = 0
        self.flushes: list[FlushRecord] = []
        self.served: list[ServeRequest] = []

    # -- model registry ----------------------------------------------------

    def register(self, key, params=None, spec=None, *, kind: str | None = None,
                 packed=None, backend: str = "auto",
                 dense_stack: str = "auto", mesh=None) -> Any:
        """Register a model config under ``key`` and activate it if the
        server is idle.

        Either pass float ``params`` + ``spec`` (+ ``kind`` 'bcnn' |
        'bmlp' | 'transformer'; for 'transformer' ``spec`` is the
        ``configs.LMSpec`` and ``params`` come from
        ``models.transformer.init_binary_lm``) — the weight cache packs
        + folds ONCE per key, on the server's device — or a pre-``pack_*``
        tree on that device via ``packed=``.  Re-registering a known key
        is a cache hit: neither the packed tree nor the forward is
        rebuilt.  ``backend`` and ``dense_stack`` go to
        ``make_packed_forward``.  ``mesh`` puts a ``(data, model)`` mesh
        behind the queue (``distributed.sharding.make_sharded_forward``;
        ``packed=`` may then lie on any device); flush buckets are then
        rounded up to the mesh's data size.  The transformer takes no
        mesh (``ValueError``).
        """
        if key not in self._engines:
            self._engines[key] = self._build_engine(
                key, params, spec, kind=kind, packed=packed,
                backend=backend, dense_stack=dense_stack, mesh=mesh)
        else:
            # touch the weight cache so a re-register is an observable hit
            self.cache.get_or_pack(key, lambda: self._engines[key].packed)
        if self._active is None:
            self._active = key
        return key

    def _build_engine(self, key, params, spec, *, kind, packed, backend,
                      dense_stack, mesh) -> _Engine:
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if packed is not None:
            # a mesh places the tree itself, from wherever it lies
            on = None if mesh is not None else C.packed_device(packed)
            if on is not None and on != self.device:
                raise ValueError(f"packed tree on {on}, server on "
                                 f"{self.device}")
            packed_tree = self.cache.get_or_pack(key, lambda: packed)
        else:
            if kind not in ("bcnn", "bmlp", "transformer"):
                raise ValueError(
                    f"kind must be 'bcnn', 'bmlp', or 'transformer', "
                    f"got {kind!r}")
            if kind == "transformer":
                from repro_torch.models import transformer as TF
                pack = TF.pack_transformer
            else:
                pack = C.pack_bcnn if kind == "bcnn" else C.pack_bmlp
            packed_tree = self.cache.get_or_pack(
                key, lambda: pack(params, spec, device=self.device))
        kind = C.packed_kind(packed_tree)
        if kind == "transformer" and mesh is not None:
            raise ValueError(
                "mesh serving is not supported for the transformer "
                "workload (the sharding rules cover bcnn/bmlp)")
        if mesh is not None:
            from repro_torch.distributed.sharding import make_sharded_forward
            fwd = make_sharded_forward(packed_tree, mesh, backend=backend,
                                       dense_stack=dense_stack,
                                       telemetry=self.telemetry)
            batch_multiple = fwd.batch_multiple
        else:
            fwd = C.make_packed_forward(packed_tree, backend=backend,
                                        dense_stack=dense_stack)
            batch_multiple = 1
        input_dtype, input_limit = _input_type(packed_tree)
        return _Engine(kind=kind, packed=packed_tree, fwd=fwd,
                       example_shape=C.packed_input_shape(packed_tree),
                       input_dtype=input_dtype, input_limit=input_limit,
                       kw_words=C.packed_dense_kw_words(packed_tree),
                       batch_multiple=batch_multiple,
                       buckets=tuple(sorted({
                           _ceil_mult(b, batch_multiple)
                           for b in self._bucket_template})))

    def use(self, key) -> list[ServeRequest]:
        """Switch the active model.  Pending requests were submitted
        against the current model, so they are force-flushed first; the
        completions are returned.  Packed weights and forwards of BOTH
        models stay warm — swapping back is free (cache hit)."""
        if key not in self._engines:
            raise KeyError(f"unknown model key {key!r}")
        done = self.flush() if self._queue else []
        self._active = key
        return done

    def invalidate(self, key) -> list[ServeRequest]:
        """Evict ``key`` from the weight cache and engine registry (call
        after a weight update; the next ``register`` re-packs).

        Requests queued against the active model were admitted under the
        OLD weights, so invalidating it force-flushes them first (same
        contract as :meth:`use`); the completions are returned.
        """
        done = (self.flush()
                if key == self._active and self._queue else [])
        self.cache.invalidate(key)
        self._engines.pop(key, None)
        if self._active == key:
            self._active = None
        return done

    def rebuild_engine(self, key, *, packed=None, params=None, spec=None,
                       kind: str | None = None, backend: str = "auto",
                       dense_stack: str = "auto", mesh=None) -> Any:
        """Drop and rebuild the engine for ``key`` WITHOUT flushing
        pending work — the recovery seam after a device loss.

        ``use``/``invalidate`` force-flush through the OLD engine first;
        after a device loss that engine's forward can never complete, so
        the caller swaps the engine out from under the queue instead: the
        cache entry and forward are dropped, a new engine is built from
        ``packed`` (typically the warm-restored tree) on ``mesh`` (or
        ``params`` + ``spec``), and the still-queued requests are served
        by the NEW engine on the next step — zero requests lost.
        """
        if key not in self._engines:
            raise KeyError(f"unknown model key {key!r}")
        self.cache.invalidate(key)
        self._engines.pop(key)
        self._engines[key] = self._build_engine(
            key, params, spec, kind=kind, packed=packed,
            backend=backend, dense_stack=dense_stack, mesh=mesh)
        return key

    def engine(self, key=None) -> _Engine:
        """The registered engine for ``key`` (active model if None) —
        read-only introspection for tests and callers (packed tree,
        forward, buckets, input type, route facts)."""
        key = self._active if key is None else key
        if key not in self._engines:
            raise KeyError(f"unknown model key {key!r}")
        return self._engines[key]

    # -- queue -------------------------------------------------------------

    @property
    def active(self):
        return self._active

    def pending(self) -> int:
        return len(self._queue)

    def submit(self, x, *, deadline: float | None = None) -> int:
        """Admit one example FIFO; returns its rid.  ``deadline`` is
        seconds from now (``default_deadline`` if None).  Raises
        :class:`BackpressureError` when ``max_queue`` requests are
        already pending — the request is SHED, never admitted (the
        fourth lifecycle outcome; the caller backs off or retries) — and
        ``ValueError`` for an example the active model cannot take
        (shape, type or value range), before admission."""
        eng = self._active_engine()
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._m_rejected.inc()
            self._m_shed.inc()
            raise BackpressureError(
                f"queue full ({self.max_queue} pending) — backpressure")
        return self._admit(_as_input(eng, x), deadline)

    def _admit(self, x: torch.Tensor, deadline: float | None) -> int:
        now = self._clock()
        dl = self.default_deadline if deadline is None else deadline
        req = ServeRequest(rid=self._next_rid, x=x, deadline=now + dl,
                           submitted_at=now)
        self._next_rid += 1
        self._queue.append(req)
        self._m_submitted.inc()
        self._m_depth.set(len(self._queue))
        tr = self.telemetry.tracer
        if tr.enabled:
            req.trace_submit_ns = tr.now_ns()
            tr.instant("serve.submit", rid=req.rid)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Evict a still-queued request; True if it was pending."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                self._m_cancelled.inc()
                self._m_depth.set(len(self._queue))
                return True
        return False

    def step(self, now: float | None = None) -> list[ServeRequest]:
        """One scheduling step: flush every full ``max_batch`` window,
        then — if the oldest pending deadline has expired — flush the
        rest of the queue too.  Returns the requests completed by this
        step (possibly empty: a partial batch whose deadline is still
        in the future keeps waiting for riders)."""
        now = self._clock() if now is None else now
        done: list[ServeRequest] = []
        while len(self._queue) >= self.max_batch:
            done += self._flush_window(self.max_batch)
        if self._queue and min(r.deadline for r in self._queue) <= now:
            while self._queue:
                done += self._flush_window(self.max_batch)
        return done

    def flush(self) -> list[ServeRequest]:
        """Force-drain the queue regardless of deadlines (shutdown /
        model swap)."""
        done: list[ServeRequest] = []
        while self._queue:
            done += self._flush_window(self.max_batch)
        return done

    def serve(self, xs, *, deadline: float | None = None
              ) -> list[torch.Tensor]:
        """Convenience: submit every example, drain, return result rows in
        submission order (the batch-API view of the queue).

        The drain flushes the WHOLE queue, so requests other callers had
        pending complete too; their completions stay claimable via
        :meth:`take` (they are not lost to this caller's return value).
        Own results are collected from the flush returns directly, so
        ``serve`` works for request counts beyond the mailbox cap.
        Admission is all-or-nothing: every example is checked, and the
        batch is shed with :class:`BackpressureError` if it would
        overflow ``max_queue``, before ANY submit, so a failed call never
        strands half its requests in the queue.
        """
        eng = self._active_engine()
        xs = [_as_input(eng, x) for x in xs]
        if self.max_queue is not None and \
                len(self._queue) + len(xs) > self.max_queue:
            self._m_rejected.inc(len(xs))   # same pair submit() bumps
            self._m_shed.inc(len(xs))
            raise BackpressureError(
                f"serve({len(xs)}) would overflow max_queue="
                f"{self.max_queue} ({len(self._queue)} pending) — "
                "backpressure")
        rids = [self._admit(x, deadline) for x in xs]
        by_rid = {r.rid: r for r in self.flush()}
        for rid in rids:                       # claimed here, not via take()
            self._completed.pop(rid, None)
        bad = [(rid, by_rid[rid].status) for rid in rids
               if by_rid[rid].status != "ok"]
        if bad:
            # the batch-API view has no per-request status channel, so a
            # non-ok outcome must raise rather than hand back None rows
            raise RuntimeError(
                f"serve(): {len(bad)} request(s) ended non-ok: {bad[:4]}"
                f"{'...' if len(bad) > 4 else ''}")
        return [by_rid[rid].result for rid in rids]

    def take(self, rid: int) -> ServeRequest | None:
        """Claim a completed request by rid (None if unknown / still
        pending).  Every flush parks its completions here until claimed,
        so a caller polling ``step()`` for its own rid still gets its
        result even when ANOTHER caller's flush/serve drained the queue
        — each completion is delivered exactly once per channel."""
        return self._completed.pop(rid, None)

    def route_for(self, batch: int) -> str:
        """The K4 route a flush of ``batch`` requests takes for the
        ACTIVE model ('gemv' | 'gemm') — ``kernels.ops.dispatch_batch``
        on the padded bucket and the model's widest packed-K extent.
        Raises ``RuntimeError`` when no model is active."""
        eng = self._active_engine()
        return kops.dispatch_batch(self._bucket_for(eng, batch),
                                   eng.kw_words)

    # -- flush machinery ---------------------------------------------------

    def _active_engine(self) -> _Engine:
        if self._active is None:
            raise RuntimeError("no model registered")
        return self._engines[self._active]

    def _bucket_for(self, eng: _Engine, n: int) -> int:
        for b in eng.buckets:
            if b >= n:
                return b
        return eng.buckets[-1]

    def _timed_out(self, r: ServeRequest, now: float) -> bool:
        """Deadline exceeded past the grace factor: the request is
        completed as ``timeout`` instead of served stale.  Grace is a
        multiple of the request's own deadline BUDGET (submit → flush
        deadline), so a 5 ms-deadline request with grace 4 times out
        20 ms after submission; ``timeout_grace=None`` disables.

        A non-positive budget (``submit(x, deadline=0)`` means "flush
        me NOW", not "time me out now") would make ANY later flush a
        timeout under a wall clock, so it falls back to the server's
        ``default_deadline`` as the grace base."""
        if self.timeout_grace is None:
            return False
        budget = r.deadline - r.submitted_at
        if budget <= 0.0:
            budget = self.default_deadline
        return now > r.submitted_at + self.timeout_grace * budget

    def _finish(self, r: ServeRequest, status: str, now: float, *,
                result=None, error: BaseException | None = None) -> None:
        """Move one request to its terminal state — the ONLY writer of
        ``status``, so 'exactly one terminal state per rid' holds by
        construction (re-finishing a finished request is a bug)."""
        assert status in TERMINAL_STATES, status
        assert r.status == "pending", (r.rid, r.status, status)
        r.status = status
        r.result = result
        r.error = error
        r.completed_at = now
        self._h_latency.observe(r.latency)
        if status == "ok":
            self._m_completed.inc()
        elif status == "timeout":
            self._m_timeouts.inc()
        else:
            self._m_errors.inc()
        self.served.append(r)
        del self.served[:-self._completed_cap]
        self._completed[r.rid] = r
        while len(self._completed) > self._completed_cap:
            self._completed.popitem(last=False)

    def _dispatch(self, eng: _Engine, buf, reqs: list[ServeRequest]):
        """The flush seam: everything device-side of one dispatch
        attempt.  ``flush_hook`` (fault injection, chaos testing) wraps
        the default ``eng.fwd(buf)`` call when installed."""
        if self.flush_hook is not None:
            return self.flush_hook(eng, buf, reqs, lambda: eng.fwd(buf))
        return eng.fwd(buf)

    def _serve_cohort(self, reqs: list[ServeRequest],
                      eng: _Engine) -> list[ServeRequest]:
        """Serve one cohort: pad to its bucket, dispatch with bounded
        retry/backoff, bisect on persistent failure, complete every
        request terminally.  Failure isolation contract:

        * an exception from the dispatch fails only THIS cohort — it is
          retried ``retry.max_retries`` times with exponential backoff,
          then the cohort bisects (fresh budget per half) until the
          poison singleton completes as ``error`` while its former
          cohort-mates are served;
        * :class:`DeviceLossError` short-circuits all of that: EVERY
          still-pending request of the cohort goes back to the FRONT of
          the queue — including bisection siblings that were never
          dispatched, at any recursion depth — and the error propagates
          to the caller (engine rebuild), after which the requeued
          requests are served by the new engine.

        The requeue lives HERE, on the outermost cohort, not inside the
        bisection recursion: a per-half requeue would save only the half
        that was dispatching and silently lose its not-yet-dispatched
        siblings (no terminal state, ``take()`` returns None forever).
        """
        try:
            return self._dispatch_cohort(reqs, eng)
        except DeviceLossError:
            pending = [r for r in reqs if r.status == "pending"]
            self._queue.extendleft(reversed(pending))
            self._m_depth.set(len(self._queue))
            raise

    def _dispatch_cohort(self, reqs: list[ServeRequest],
                         eng: _Engine) -> list[ServeRequest]:
        tr = self.telemetry.tracer
        bucket = self._bucket_for(eng, len(reqs))
        t0 = self._clock()
        with tr.span("serve.pack", batch=len(reqs), bucket=bucket):
            buf = self.pool.batch_buffer(bucket, eng.example_shape,
                                         eng.input_dtype)
            torch.stack([r.x for r in reqs], out=buf[:len(reqs)])
            buf[len(reqs):] = 0
        route = kops.dispatch_batch(bucket, eng.kw_words)
        attempt = 0
        while True:
            try:
                with tr.span("serve.dispatch", route=route):
                    out_dev = self._dispatch(eng, buf, reqs)
                with tr.span("serve.compute"):
                    out = out_dev.cpu()   # blocks on the device work
                break
            except DeviceLossError:
                raise        # not batch-local: _serve_cohort requeues
            except Exception as e:
                if attempt < self.retry.max_retries:
                    attempt += 1
                    self._m_retries.inc()
                    self._sleep(self.retry.backoff(attempt))
                    continue
                if len(reqs) == 1:
                    with tr.span("serve.complete"):
                        self._finish(reqs[0], "error", self._clock(),
                                     error=e)
                        self._m_depth.set(len(self._queue))
                    return list(reqs)
                self._m_bisections.inc()
                mid = len(reqs) // 2
                return (self._dispatch_cohort(reqs[:mid], eng) +
                        self._dispatch_cohort(reqs[mid:], eng))
        with tr.span("serve.complete"):
            now = self._clock()
            for i, r in enumerate(reqs):
                self._h_wait.observe(max(0.0, t0 - r.submitted_at))
                self._finish(r, "ok", now, result=out[i])
            self.flushes.append(FlushRecord(
                batch=len(reqs), bucket=bucket, route=route,
                at=now, wall_s=now - t0, retries=attempt))
            del self.flushes[:-self._completed_cap]
            self._m_flushes.inc()
            self._m_routes[route].inc()
            self._m_padded.inc(bucket - len(reqs))
            self._m_depth.set(len(self._queue))
            self._h_flush.observe(now - t0)
        return list(reqs)

    def _flush_window(self, limit: int) -> list[ServeRequest]:
        """One flush: pop a FIFO window, triage expired requests to
        ``timeout``, then serve the live cohort (`_serve_cohort` does
        pad → dispatch-with-retry → complete, bisecting on failure).

        The serving lifecycle is traced per phase when the server's
        tracer is enabled, with the reference's span names: a
        ``serve.flush`` parent wrapping ``serve.bucket_pad`` →
        ``serve.pack`` → ``serve.dispatch`` (the forward's launches are
        enqueued) → ``serve.compute`` (the host copy blocks on the device
        work) → ``serve.complete``, plus one explicit-time
        ``serve.queue_wait`` span per request (submit → flush start).
        Metrics (queue-wait / latency / flush-wall histograms, route +
        padded-row + lifecycle counters) update unconditionally — they are
        a few dict ops per flush.
        """
        tr = self.telemetry.tracer
        flush_t0 = tr.now_ns() if tr.enabled else 0
        with tr.span("serve.bucket_pad"):
            reqs = [self._queue.popleft()
                    for _ in range(min(limit, len(self._queue)))]
            if not reqs:
                return []
            eng = self._active_engine()
            now = self._clock()
        if tr.enabled:
            for r in reqs:
                if r.trace_submit_ns is not None:
                    tr.add_complete("serve.queue_wait", r.trace_submit_ns,
                                    flush_t0, rid=r.rid)
        done: list[ServeRequest] = []
        live: list[ServeRequest] = []
        for r in reqs:
            if self._timed_out(r, now):
                self._finish(r, "timeout", now)
                done.append(r)
            else:
                live.append(r)
        flush_args: dict = {"batch": len(reqs)}
        if not live:
            self._m_depth.set(len(self._queue))
        else:
            bucket = self._bucket_for(eng, len(live))
            flush_args["bucket"] = bucket
            flush_args["route"] = kops.dispatch_batch(bucket, eng.kw_words)
            done += self._serve_cohort(live, eng)
        if tr.enabled:
            tr.add_complete("serve.flush", flush_t0, tr.now_ns(),
                            **flush_args)
        return done


def latency_percentile(sorted_vals, q: float):
    """Nearest-rank percentile over a pre-sorted latency list — the one
    definition the serving CLI (``launch/serve.py``) and ``chip_smoke.py``'s
    serving phase report.

    Raises ``ValueError`` on an empty sequence and on a ``q`` outside
    [0, 1].  A single sample returns that sample for every ``q``.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"percentile q must be in [0, 1], got {q!r}")
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("latency_percentile of an empty sequence")
    return sorted_vals[min(n - 1, int(n * q))]


class SimClock:
    """Deterministic monotonic clock for tests: inject as
    ``PackedInferenceServer(clock=...)`` and drive time by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


# ---------------------------------------------------------------------------
# LM decode serving (the model zoo): step factories + slot-ring driver
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, max_len: int):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, tokens, idx):
        return M.decode_step(params, cfg, tokens, cache, idx)
    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any                # (S,) integer ids: a tensor or a sequence
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    truncated: bool = False    # hit the cache length before max_new tokens


class BatchedServer:
    """Minimal continuous-batching server over the decode step.

    All sequences share one ring of decode slots; finished requests free
    their slot for the next queued prompt.  The server serves on
    ``device``, the card unless the caller asks for the CPU: the params
    are placed there (the same tensors where they are there already), and
    it holds one decode cache there, which every step updates in place.
    """

    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 device="cuda"):
        self.device = _check_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device)
                               if isinstance(t, torch.Tensor) else t, params)
        self.max_len = max_len
        self.slots = batch_slots
        self.cache = M.init_cache(self.params, cfg, batch_slots, max_len)
        self.decode = make_decode_step(cfg)
        self.active: dict[int, Request] = {}
        self.idx = 0

    def _reset_slot(self, s: int) -> None:
        """Zero the freed slot's cache rows (K/V and recurrent state).

        A reused slot would otherwise inherit the previous request's rows
        at positions < self.idx.  Cache leaves are (L, B, ...) with the
        slot axis at 1.  The decode mask stays global (j <= idx), so the
        zeroed positions still take softmax weight and dilute the new
        occupant's attention against decoding it alone, as in the
        reference.
        """
        for _, a in leaves_with_path(self.cache):
            if a.ndim >= 2 and a.shape[1] == self.slots:
                a[:, s] = 0

    def submit_and_run(self, requests: list[Request]) -> list[Request]:
        """Greedy decode of every request (prompts are consumed token by
        token through the decode path).

        Every submitted request appears in the return value: completed
        (``max_new`` tokens) or flagged ``truncated=True`` when the shared
        cache ran out of positions first (requests still queued then come
        back truncated with empty output).  Each call starts a fresh cache
        window.
        """
        queue = list(requests)
        for r in queue:
            r.out = []
            r.truncated = False
        done: list[Request] = []
        slot_req: dict[int, Request] = {}
        pos = [0] * self.slots
        self.idx = 0
        while (queue or slot_req) and self.idx < self.max_len:
            for s in range(self.slots):
                if s not in slot_req and queue:
                    slot_req[s] = queue.pop(0)
                    pos[s] = 0
            step_tok = []
            for s in range(self.slots):
                r = slot_req.get(s)
                if r is None:
                    step_tok.append(0)
                elif pos[s] < len(r.prompt):
                    step_tok.append(int(r.prompt[pos[s]]))
                else:
                    step_tok.append(r.out[-1] if r.out else 0)
            tok = torch.tensor(step_tok, dtype=torch.int32,
                               device=self.device)[:, None]
            logits, self.cache = self.decode(self.params, self.cache, tok,
                                             self.idx)
            nxt = torch.argmax(logits[:, 0], dim=-1).tolist()
            for s in list(slot_req):
                r = slot_req[s]
                pos[s] += 1
                if pos[s] >= len(r.prompt):
                    r.out.append(int(nxt[s]))
                    if len(r.out) >= r.max_new:
                        done.append(r)
                        del slot_req[s]
                        self._reset_slot(s)
            self.idx += 1
        for s, r in list(slot_req.items()):
            r.truncated = True
            done.append(r)
            self._reset_slot(s)
        for r in queue:
            r.truncated = True
            done.append(r)
        return done
