"""Experiment configuration: YAML file + programmatic overrides.

Accepts the reference's YAML schema (docs/shadow_config_spec.md;
src/main/core/support/configuration.rs): ``general``, ``network``,
``experimental``, ``host_defaults``, and ``hosts.<name>`` with a ``processes``
list and ``quantity`` expansion. Host defaults merge field-wise into each host
(configuration.rs:102-108); unknown fields are rejected like serde's
``deny_unknown_fields``.

Device-facing additions (not in the reference schema) live under
``experimental``: event pool capacity, per-window event cap, sockets per host
— the static shapes the TPU engine compiles against.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Optional

import yaml

from shadow_tpu_torch.core import units


class ConfigError(ValueError):
    pass


def _check_fields(section: str, d: dict, allowed: set[str]) -> None:
    unknown = set(d) - allowed
    if unknown:
        raise ConfigError(f"unknown field(s) in {section}: {sorted(unknown)}")


@dataclasses.dataclass
class GeneralOptions:
    """docs/shadow_config_spec.md `general` (configuration.rs:129-178)."""

    stop_time: int = 0  # ns
    seed: int = 1
    parallelism: int = 1
    bootstrap_end_time: int = 0  # ns; infinite-bandwidth lossless warmup
    log_level: str = "info"
    heartbeat_interval: int = units.parse_time_ns("1 s")
    data_directory: str = "shadow.data"
    template_directory: Optional[str] = None
    progress: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "GeneralOptions":
        _check_fields("general", d, {f.name for f in dataclasses.fields(cls)})
        out = cls()
        if "stop_time" not in d:
            raise ConfigError("general.stop_time is required")
        out.stop_time = units.parse_time_ns(d["stop_time"])
        out.seed = int(d.get("seed", out.seed))
        out.parallelism = int(d.get("parallelism", out.parallelism))
        out.bootstrap_end_time = units.parse_time_ns(d.get("bootstrap_end_time", 0))
        out.log_level = str(d.get("log_level", out.log_level))
        out.heartbeat_interval = units.parse_time_ns(
            d.get("heartbeat_interval", "1 s")
        )
        out.data_directory = str(d.get("data_directory", out.data_directory))
        td = d.get("template_directory")
        out.template_directory = None if td is None else str(td)
        out.progress = bool(d.get("progress", False))
        return out


@dataclasses.dataclass
class GraphSource:
    """network.graph: gml file/inline or built-in named graph."""

    type: str = "gml"  # "gml" | "1_gbit_switch"
    path: Optional[str] = None
    inline: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "GraphSource":
        _check_fields("network.graph", d, {"type", "path", "inline", "file"})
        g = cls(type=str(d.get("type", "gml")))
        if g.type not in ("gml", "1_gbit_switch"):
            raise ConfigError(f"unknown network.graph.type {g.type!r}")
        g.path = d.get("path") or d.get("file")
        g.inline = d.get("inline")
        if g.type == "gml" and not (g.path or g.inline):
            raise ConfigError("network.graph needs `path` or `inline` for type gml")
        return g


# Built-in graph matching the reference's `1_gbit_switch` compiled-in topology.
ONE_GBIT_SWITCH_GML = """\
graph [
  directed 0
  node [
    id 0
    bandwidth_down "1 Gbit"
    bandwidth_up "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
    packet_loss 0.0
  ]
]
"""


@dataclasses.dataclass
class NetworkOptions:
    """docs/shadow_config_spec.md `network` (configuration.rs:198-209)."""

    graph: GraphSource = dataclasses.field(default_factory=GraphSource)
    use_shortest_path: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkOptions":
        _check_fields("network", d, {"graph", "use_shortest_path"})
        if "graph" not in d:
            raise ConfigError("network.graph is required")
        return cls(
            graph=GraphSource.from_dict(d["graph"]),
            use_shortest_path=bool(d.get("use_shortest_path", True)),
        )


@dataclasses.dataclass
class ExperimentalOptions:
    """Reference experimental flags we honor (configuration.rs:229-340) plus
    the TPU engine's static-shape knobs."""

    # Reference-compatible:
    runahead: Optional[int] = None  # ns; None = derive from min topology latency
    interface_buffer: int = units.parse_bytes("1024000")
    interface_qdisc: str = "fifo"  # "fifo" | "roundrobin"
    socket_recv_buffer: int = 174760
    socket_send_buffer: int = 131072
    socket_recv_autotune: bool = True
    socket_send_autotune: bool = True
    use_memory_manager: bool = True
    use_seccomp: bool = True
    use_syscall_counters: bool = False
    use_object_counters: bool = True
    worker_threads: Optional[int] = None
    interpose_method: str = "preload"
    # TPU engine static shapes:
    event_capacity: int = 1 << 14  # event-pool rows per shard
    # Occupancy-adaptive pool gearing (core/gearbox.py): compile the window
    # kernel at a ladder of pool capacities (pool_gears tiers: C/4, C/2, C
    # for 3) and let the drivers pick the smallest gear covering live
    # occupancy plus hysteresis headroom at each dispatch boundary. 1 = a
    # single fixed-capacity kernel (the pre-gearbox build). Results are
    # identical either way (capacity only bounds what fits, never the
    # order); gears only change wall time and compile count.
    pool_gears: int = 1
    events_per_host_per_window: int = 32  # K: scan depth of the window kernel
    sockets_per_host: int = 8
    router_queue_slots: int = 64  # per-host CoDel ring capacity
    # router vtable variant (router.c:49-57): codel | static | single
    router_queue_variant: str = "codel"
    # per-syscall-handler wall timing (-DUSE_PERF_TIMERS analog, setup:76-79)
    use_perf_timers: bool = False
    # shim-side sim-time stamping of managed stdout/stderr lines
    # (shim_logger.c analog; off by default so app output stays byte-exact
    # for the determinism comparisons)
    use_shim_log_stamps: bool = False
    # Managed-plane path model: None = auto (lazy per-source Dijkstra with
    # a row cache — topology.c:1144-1259 analog — once the graph exceeds
    # lazy_paths_threshold used vertices; dense baked matrices below).
    # True/False force. The device plane always bakes dense (per-packet
    # lookups on device cannot fault rows in).
    lazy_paths: Optional[bool] = None
    lazy_paths_threshold: int = 4096
    # Per-packet delivery-status breadcrumb trails (packet.c:37-77 PDS_*):
    # packets carry an extra trail word; per-host registers keep the last
    # dropped/delivered packet's ordered stage chain. Debug mode (one
    # extra payload word of sort traffic).
    packet_trails: bool = False
    devices: int = 1  # mesh size over the host axis
    # Islands engine (engine.IslandSpec / parallel/islands.py): split the
    # host axis into num_shards blocks, each owning a local event pool and
    # a local dense window; cross-shard emissions ride a bounded
    # all_to_all (exchange_slots rows per destination shard per window).
    # 1 = the global single-pool engine. island_mode "vmap" batches the
    # shards on one chip (virtual islands); "shard_map" places them on
    # real mesh devices.
    num_shards: int = 1
    exchange_slots: int = 0  # 0 = auto-size
    island_mode: str = "vmap"  # "vmap" | "shard_map"
    # Asynchronous conservative sync (cs/0409032): the fused islands
    # driver advances per-shard virtual-time frontiers bounded by
    # topology-derived lookahead instead of one fleet-wide window
    # barrier; false restores the lockstep barrier loop. async_spread
    # bounds how far (ns of virtual time) any shard may run ahead of the
    # slowest before yielding its slot (roughness suppression,
    # cond-mat/0302050); 0 auto-derives from the lookahead matrix.
    async_islands: bool = True
    async_spread: int = 0
    # Multi-chip frontier exchange (parallel/islands.py): "ppermute"
    # replaces the async driver's all_gather with neighbor-only
    # collective-permute rounds covering the in-edge lookahead matrix
    # (per-chip volume scales with topology degree, not mesh size);
    # "all_gather" keeps the gather — the bench comparison arm. Chains
    # are bit-identical either way.
    mesh_exchange: str = "ppermute"  # "ppermute" | "all_gather"
    # Initial host->chip placement: "block" = contiguous global-id
    # blocks; "min_cut" = greedy affinity clustering at partition time
    # (parallel/balancer.min_cut_placement) so lookahead-critical
    # low-latency links land intra-chip (implies `rebalance`).
    placement: str = "block"  # "block" | "min_cut"
    # Dead chips to build AROUND (elastic mesh resilience,
    # parallel/elastic.py): indices into the deterministic device order
    # that the surviving-mesh rebuild must skip. Normally set by the
    # elastic runner's relayout, not by hand.
    exclude_chips: tuple = ()
    # Between-window host->shard re-sharding on load skew (the P3
    # work-stealing replacement, scheduler_policy_host_steal.c analog).
    rebalance: bool = False
    # Self-balancing fleet (parallel/balancer.py): the closed-loop
    # hot-shard controller — detect a chronic frontier laggard with
    # skewed resident load, refine the host->shard assignment by greedy
    # min-cut, migrate live at a dispatch boundary with a verified digest
    # chain, roll back + cool down on any mid-migration failure. Implies
    # `rebalance` (the slot_of routing seam). The balance_* knobs are the
    # hysteresis guards (docs/fault_tolerance.md §6).
    balancer: bool = False
    balance_hot_ratio: float = 1.5
    balance_streak: int = 3
    balance_cooldown: int = 8
    balance_max_moves: int = 8
    inbox_slots: int = 8  # B: per-host intra-window self-event slots
    outbox_slots: int = 64  # O: per-host emission slots per window
    # CPU model (host/cpu.c analog): simulated processing cost per syscall
    # on the managed-process plane; accumulated delay is applied to the
    # virtual clock once it exceeds max_unapplied_cpu_latency.
    cpu_ns_per_syscall: int = 0  # 0 = CPU model off
    max_unapplied_cpu_latency: int = units.parse_time_ns("1 us")
    # Device telemetry counter block (shadow_tpu/obs/counters.py): window
    # -plane counters + per-host event/virtual-time rows carried in
    # SimState and updated inside the jitted kernel. On by default (the
    # updates are fused adds, measured <= 3% of step time by bench.py's
    # obs-overhead smoke row); False compiles them out — the control arm
    # of that measurement.
    obs_counters: bool = True
    # Determinism-audit digest chain (shadow_tpu/obs/audit.py): fold every
    # committed event's key into the per-host rolling-mix chain inside the
    # window kernel. On by default (fused i64 arithmetic, gated <= 3% by
    # bench.py --audit-smoke); False compiles the folds out — the control
    # arm of that measurement.
    audit_digest: bool = True
    # Flight recorder (shadow_tpu/obs/flight.py): device-resident ring of
    # the last R committed event records per host, flushed to a binary
    # spool at handoff boundaries (--flight-out) and convertible into a
    # virtual-time Perfetto clock domain (tools/flight_to_trace.py).
    # Accepts an integer capacity or {capacity: R}; 0 = compiled out.
    flight_recorder: int = 0
    # Pipelined CPU↔TPU handoff (core/pipeline.py): the driver loops
    # double-buffer window dispatches — issue window N+1 asynchronously
    # while the host drains window N's deliveries, synchronizing only at
    # the fetch point. Results are bit-identical either way (speculative
    # issues are recomputed, never reused, whenever a handoff mutates
    # state); false restores the strictly-serial loop — the bench
    # comparison arm (bench.py --pipeline-smoke).
    pipelined_dispatch: bool = True
    # Multi-worker host plane (core/hostplane.py): shard the host-side
    # handoff drain per owning host across N pinned workers with a
    # deterministic (virtual-time, host-gid) merge — bit-identical to the
    # serial drain by construction. 1 (the default) keeps today's serial
    # inline drain and emits no hostplane.* metrics keys.
    host_workers: int = 1
    # Profiling plane (obs/prof.py, schema v18 `prof.*`): record a
    # fixed-capacity ring of per-handoff interval deltas (wall +
    # committed virtual time, event/window/yield/blocked counters,
    # per-shard async frontiers) plus log-bucketed latency histograms,
    # dumped as a schema-versioned profile doc (--profile-out overrides
    # the path). Off by default — the recorder is read-only against the
    # sim, but the ticks themselves cost a little host wall per handoff.
    profiler: bool = False
    # Ring capacity in intervals; oldest intervals are dropped (and
    # counted) once the ring wraps. Must be >= 8.
    profiler_ring: int = 512
    # CPU↔TPU seam: route managed-process UDP through the device-stepped
    # network (procs/bridge.py). The BASELINE north-star path.
    use_device_network: bool = False
    # Also carry managed TCP connections on the device TCP state machine
    # (net/tcp.py): handshake, Reno, retransmission and delivery timing all
    # computed by the window kernel. Requires use_device_network.
    use_device_tcp: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentalOptions":
        fields = {f.name for f in dataclasses.fields(cls)}
        # Accept (and ignore) reference-only flags that have no TPU analog so
        # reference configs load unmodified.
        ignored = {
            "use_cpu_pinning", "use_sched_fifo", "scheduler_policy",
            "preload_spin_max", "use_explicit_block_message",
            "use_shim_syscall_handler", "use_o_n_waitpid_workarounds",
            "use_legacy_working_dir", "host_heartbeat_interval",
        }
        _check_fields("experimental", d, fields | ignored)
        out = cls()
        if d.get("runahead") is not None:
            # Bare numbers are seconds (configuration.rs:289 value_name="seconds").
            out.runahead = units.parse_time_ns(d["runahead"])
        for name in ("interface_buffer", "socket_recv_buffer", "socket_send_buffer"):
            if name in d:
                setattr(out, name, units.parse_bytes(d[name]))
        for name in (
            "use_device_network", "use_device_tcp", "obs_counters",
            "audit_digest", "pipelined_dispatch",
            "socket_recv_autotune", "socket_send_autotune", "use_memory_manager",
            "use_seccomp", "use_syscall_counters", "use_object_counters",
        ):
            if name in d:
                setattr(out, name, bool(d[name]))
        if out.use_device_tcp and not out.use_device_network:
            raise ConfigError(
                "experimental.use_device_tcp requires use_device_network"
            )
        if d.get("cpu_ns_per_syscall") is not None:
            # bare numbers are NANOSECONDS here (the field name says so)
            out.cpu_ns_per_syscall = units.parse_time_ns(
                d["cpu_ns_per_syscall"], default_unit="ns"
            )
        if d.get("max_unapplied_cpu_latency") is not None:
            out.max_unapplied_cpu_latency = units.parse_time_ns(
                d["max_unapplied_cpu_latency"], default_unit="ns"
            )
        for name in (
            "event_capacity", "events_per_host_per_window", "sockets_per_host",
            "router_queue_slots", "devices", "inbox_slots", "outbox_slots",
            "num_shards", "exchange_slots", "pool_gears",
        ):
            if name in d:
                setattr(out, name, int(d[name]))
        if out.pool_gears < 1:
            raise ConfigError("experimental.pool_gears must be >= 1")
        if d.get("host_workers") is not None:
            out.host_workers = int(d["host_workers"])
            if out.host_workers < 1:
                raise ConfigError("experimental.host_workers must be >= 1")
        if "profiler" in d:
            out.profiler = bool(d["profiler"])
        if d.get("profiler_ring") is not None:
            out.profiler_ring = int(d["profiler_ring"])
            if out.profiler_ring < 8:
                raise ConfigError("experimental.profiler_ring must be >= 8")
        if d.get("flight_recorder") is not None:
            v = d["flight_recorder"]
            if isinstance(v, dict):
                _check_fields("experimental.flight_recorder", v, {"capacity"})
                v = v.get("capacity", 0)
            out.flight_recorder = int(v)
            if out.flight_recorder < 0:
                raise ConfigError(
                    "experimental.flight_recorder capacity must be >= 0"
                )
        if "rebalance" in d:
            out.rebalance = bool(d["rebalance"])
        if "balancer" in d:
            out.balancer = bool(d["balancer"])
        for name in ("balance_streak", "balance_cooldown",
                     "balance_max_moves"):
            if name in d:
                setattr(out, name, int(d[name]))
                if getattr(out, name) < 1:
                    raise ConfigError(
                        f"experimental.{name} must be >= 1"
                    )
        if "balance_hot_ratio" in d:
            out.balance_hot_ratio = float(d["balance_hot_ratio"])
            if out.balance_hot_ratio <= 1.0:
                raise ConfigError(
                    "experimental.balance_hot_ratio must be > 1.0 (a "
                    "ratio at/below the mean would trigger constantly)"
                )
        if "async_islands" in d:
            out.async_islands = bool(d["async_islands"])
        if d.get("async_spread") is not None:
            out.async_spread = units.parse_time_ns(
                d["async_spread"], default_unit="ns"
            )
            if out.async_spread < 0:
                raise ConfigError(
                    "experimental.async_spread must be >= 0 ns"
                )
        if "island_mode" in d:
            v = str(d["island_mode"]).lower()
            if v not in ("vmap", "shard_map"):
                raise ConfigError(f"unknown island_mode {v!r}")
            out.island_mode = v
        if d.get("exclude_chips") is not None:
            v = d["exclude_chips"]
            if (not isinstance(v, (list, tuple))
                    or not all(isinstance(c, int) and c >= 0 for c in v)):
                raise ConfigError(
                    "experimental.exclude_chips must be a list of "
                    "non-negative chip indices"
                )
            out.exclude_chips = tuple(int(c) for c in v)
        if "mesh_exchange" in d:
            v = str(d["mesh_exchange"]).lower()
            if v not in ("ppermute", "all_gather"):
                raise ConfigError(f"unknown mesh_exchange {v!r}")
            out.mesh_exchange = v
        if "placement" in d:
            v = str(d["placement"]).lower()
            if v not in ("block", "min_cut"):
                raise ConfigError(f"unknown placement {v!r}")
            out.placement = v
        if "use_perf_timers" in d:
            out.use_perf_timers = bool(d["use_perf_timers"])
        if "use_shim_log_stamps" in d:
            out.use_shim_log_stamps = bool(d["use_shim_log_stamps"])
        if "lazy_paths" in d and d["lazy_paths"] is not None:
            out.lazy_paths = bool(d["lazy_paths"])
        if "lazy_paths_threshold" in d:
            out.lazy_paths_threshold = int(d["lazy_paths_threshold"])
        if "packet_trails" in d:
            out.packet_trails = bool(d["packet_trails"])
        if "router_queue_variant" in d:
            v = str(d["router_queue_variant"]).lower()
            if v not in ("codel", "static", "single"):
                raise ConfigError(f"unknown router_queue_variant {v!r}")
            out.router_queue_variant = v
        if "worker_threads" in d and d["worker_threads"] is not None:
            out.worker_threads = int(d["worker_threads"])
        if "interface_qdisc" in d:
            q = str(d["interface_qdisc"]).lower()
            if q not in ("fifo", "roundrobin", "rr"):
                raise ConfigError(f"unknown interface_qdisc {q!r}")
            out.interface_qdisc = "roundrobin" if q in ("roundrobin", "rr") else "fifo"
        if "interpose_method" in d:
            out.interpose_method = str(d["interpose_method"])
        return out


@dataclasses.dataclass
class ProcessOptions:
    """hosts.<name>.processes[*] (configuration.rs:471-515)."""

    path: str = ""
    args: list[str] = dataclasses.field(default_factory=list)
    environment: dict[str, str] = dataclasses.field(default_factory=dict)
    quantity: int = 1
    start_time: int = 0  # ns
    stop_time: Optional[int] = None  # ns

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessOptions":
        _check_fields(
            "process", d,
            {"path", "args", "environment", "quantity", "start_time", "stop_time"},
        )
        if "path" not in d:
            raise ConfigError("process.path is required")
        args = d.get("args", [])
        if isinstance(args, str):
            args = args.split()
        env = d.get("environment", {}) or {}
        if isinstance(env, str):
            env = dict(kv.split("=", 1) for kv in env.split(";") if kv)
        out = cls(
            path=str(d["path"]),
            args=[str(a) for a in args],
            environment={str(k): str(v) for k, v in env.items()},
            quantity=int(d.get("quantity", 1)),
            start_time=units.parse_time_ns(d.get("start_time", 0)),
            stop_time=(
                units.parse_time_ns(d["stop_time"])
                if d.get("stop_time") is not None
                else None
            ),
        )
        if out.stop_time is not None and out.stop_time <= out.start_time:
            raise ConfigError(
                f"process {out.path}: stop_time must be after start_time"
            )
        return out


@dataclasses.dataclass
class HostOptions:
    """hosts.<name> merged with host_defaults (configuration.rs:386-431,498+)."""

    name: str = ""
    bandwidth_down: Optional[int] = None  # bits/sec; None = from graph vertex
    bandwidth_up: Optional[int] = None
    ip_address_hint: Optional[str] = None
    country_code_hint: Optional[str] = None
    city_code_hint: Optional[str] = None
    log_level: Optional[str] = None
    pcap_directory: Optional[str] = None
    network_node_id: Optional[int] = None
    quantity: int = 1
    processes: list[ProcessOptions] = dataclasses.field(default_factory=list)
    # Device-side app model (shadow_tpu extension): workloads that run fully
    # on-device with no managed process — "phold", "udp_flood", "tcp_bulk",
    # "udp_echo_server", ... with model-specific options.
    app_model: Optional[str] = None
    app_options: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Device-plane CPU model (host/cpu.c analog): simulated processing cost
    # per device event; a loaded host's events serialize on its virtual CPU.
    cpu_ns_per_event: int = 0

    @classmethod
    def from_dict(cls, name: str, d: dict, defaults: dict) -> "HostOptions":
        allowed = {
            "bandwidth_down", "bandwidth_up", "options", "quantity", "processes",
            "ip_address_hint", "country_code_hint", "city_code_hint",
            "log_level", "pcap_directory", "network_node_id",
            "app_model", "app_options", "heartbeat_interval",
            "heartbeat_log_info", "heartbeat_log_level", "cpu_ns_per_event",
        }
        _check_fields(f"hosts.{name}", d, allowed)
        merged = dict(defaults)
        merged.update(d.get("options", {}) or {})
        merged.update({k: v for k, v in d.items() if k not in ("processes", "options")})
        out = cls(name=name)
        if merged.get("bandwidth_down") is not None:
            out.bandwidth_down = units.parse_bits(merged["bandwidth_down"])
        if merged.get("bandwidth_up") is not None:
            out.bandwidth_up = units.parse_bits(merged["bandwidth_up"])
        for f in (
            "ip_address_hint", "country_code_hint", "city_code_hint",
            "log_level", "pcap_directory",
        ):
            if merged.get(f) is not None:
                setattr(out, f, str(merged[f]))
        if merged.get("network_node_id") is not None:
            out.network_node_id = int(merged["network_node_id"])
        out.quantity = int(merged.get("quantity", 1))
        out.processes = [ProcessOptions.from_dict(p) for p in d.get("processes", [])]
        if merged.get("app_model") is not None:
            out.app_model = str(merged["app_model"])
        out.app_options = dict(merged.get("app_options", {}) or {})
        if merged.get("cpu_ns_per_event") is not None:
            out.cpu_ns_per_event = units.parse_time_ns(
                merged["cpu_ns_per_event"], default_unit="ns"
            )
        return out

    def expand(self) -> list["HostOptions"]:
        """quantity: N>1 → N hosts named name1..nameN (reference:
        controller.c:277-280 appends i+1 for every host when quantity > 1)."""
        if self.quantity <= 1:
            return [self]
        out = []
        for i in range(1, self.quantity + 1):
            h = dataclasses.replace(self, quantity=1)
            h.name = f"{self.name}{i}"
            out.append(h)
        return out


@dataclasses.dataclass
class FaultOptions:
    """`faults` section: deterministic fault injection + recovery policy
    (shadow_tpu/faults; no reference analog — Shadow dies whole-run on any
    plugin failure)."""

    # fault-plan JSON file (same schema as --fault-plan), merged with the
    # inline `inject` list; both are virtual-time-keyed injection lists
    plan: Optional[str] = None
    inject: list[dict] = dataclasses.field(default_factory=list)
    # what the supervisor does when a managed process wedges (IPC-timeout
    # escalation ladder exhausted) — abort the run, or quarantine the
    # simulated host (mark it dead, drain its events, keep running)
    on_proc_failure: str = "abort"
    # escalation ladder: extra timed waits (doubling backoff) before a
    # non-responsive managed process is declared wedged
    ipc_timeout_retries: int = 1
    # what the backend supervisor (core/supervisor.py) does when the
    # ACCELERATOR is lost mid-run: wait (drain to checkpoint, re-probe
    # until it returns, hot-resume), cpu (drain, re-lower the kernels on
    # the CPU backend and keep advancing, upshift back on recovery), or
    # abort (drain, then raise — resume with --resume). None = supervision
    # only arms when the fault plan carries backend ops (then abort).
    on_backend_loss: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "FaultOptions":
        _check_fields(
            "faults", d,
            {"plan", "inject", "on_proc_failure", "ipc_timeout_retries",
             "on_backend_loss"},
        )
        out = cls()
        if d.get("plan") is not None:
            out.plan = str(d["plan"])
        if d.get("inject"):
            out.inject = list(d["inject"])
            # the fault plane is not ported yet (ROADMAP.md, queue A 11):
            # refuse at config time rather than run without the faults
            raise ConfigError(
                "faults.inject: the fault plane is not ported to "
                "shadow_tpu_torch yet (ROADMAP.md queue A 11)"
            )
        if "on_proc_failure" in d:
            v = str(d["on_proc_failure"]).lower()
            if v not in ("abort", "quarantine"):
                raise ConfigError(
                    f"faults.on_proc_failure must be abort|quarantine, "
                    f"got {v!r}"
                )
            out.on_proc_failure = v
        if "ipc_timeout_retries" in d:
            out.ipc_timeout_retries = int(d["ipc_timeout_retries"])
            if out.ipc_timeout_retries < 0:
                raise ConfigError("faults.ipc_timeout_retries must be >= 0")
        if d.get("on_backend_loss") is not None:
            v = str(d["on_backend_loss"]).lower()
            if v not in ("wait", "cpu", "abort", "relayout"):
                raise ConfigError(
                    f"faults.on_backend_loss must be "
                    f"wait|cpu|abort|relayout, "
                    f"got {v!r}"
                )
            out.on_backend_loss = v
        return out

    def load_faults(self) -> list:
        """Materialize the merged injection list (plan file + inline),
        ordered by (at, declaration)."""
        raise NotImplementedError(
            "the fault plane is not ported to shadow_tpu_torch yet "
            "(ROADMAP.md queue A 11)"
        )


@dataclasses.dataclass
class FleetOptions:
    """`fleet` section: batched multi-experiment execution knobs
    (shadow_tpu/fleet; consumed by the `sweep` CLI subcommand). These are
    scheduler-plane values — they never compile into the window kernel,
    so sweep jobs may carry them without breaking kernel sharing."""

    lanes: int = 0  # device lanes; 0 = one lane per job
    deadline_s: Optional[float] = None  # wall-clock budget per job
    sync: str = "conservative"  # "conservative" | "optimistic"
    windows_per_dispatch: int = 32
    checkpoint_every: int = 0  # ns of fleet frontier; 0 = off
    checkpoint_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "FleetOptions":
        _check_fields(
            "fleet", d,
            {"lanes", "deadline_s", "sync", "windows_per_dispatch",
             "checkpoint_every", "checkpoint_dir"},
        )
        out = cls()
        if "lanes" in d:
            out.lanes = int(d["lanes"])
            if out.lanes < 0:
                raise ConfigError("fleet.lanes must be >= 0")
        if d.get("deadline_s") is not None:
            out.deadline_s = float(d["deadline_s"])
            if out.deadline_s <= 0:
                raise ConfigError("fleet.deadline_s must be > 0")
        if "sync" in d:
            v = str(d["sync"]).lower()
            if v not in ("conservative", "optimistic"):
                raise ConfigError(
                    f"fleet.sync must be conservative|optimistic, got {v!r}"
                )
            out.sync = v
        if "windows_per_dispatch" in d:
            out.windows_per_dispatch = int(d["windows_per_dispatch"])
            if out.windows_per_dispatch < 1:
                raise ConfigError("fleet.windows_per_dispatch must be >= 1")
        if d.get("checkpoint_every") is not None:
            out.checkpoint_every = units.parse_time_ns(d["checkpoint_every"])
        if d.get("checkpoint_dir") is not None:
            out.checkpoint_dir = str(d["checkpoint_dir"])
        return out


@dataclasses.dataclass
class QdiscOptions:
    """`qdisc` section: the per-interface scheduling plane
    (shadow_tpu/net/qdisc). `discipline: fifo` (the default) keeps the
    NIC's plain send ring — runs with no qdisc section are bit-identical
    to pre-qdisc builds. pifo/eiffel own a device-resident `[H, Q]` queue
    plane stepped inside the window kernel; every knob here shapes that
    kernel, so sweep jobs may NOT vary this section (fleet/sweep
    DATA_PATHS excludes it, same as experimental)."""

    # fifo | roundrobin | pifo | eiffel ("fifo" defers to the legacy
    # experimental.interface_qdisc string so old configs keep working)
    discipline: str = "fifo"
    rank: str = "fifo"  # fifo | prio | wfq
    queue_slots: int = 64  # per-host queue capacity Q
    buckets: int = 16  # eiffel: bucket count B
    bucket_width: int = 1  # eiffel: rank units per bucket
    classes: int = 4  # wfq/shaping flow classes
    weights: Optional[list] = None  # per-class wfq weights (len == classes)
    # per-class token-bucket shaping rates, class index → bandwidth
    # (e.g. {0: "10 Mbit"}); empty = unshaped
    shaping: dict = dataclasses.field(default_factory=dict)
    drop: str = "none"  # none | red | codel
    red_min_frac: float = 0.25
    red_max_frac: float = 0.75
    red_max_p: float = 0.1
    # host-name-prefix → flow class pin (applies to every expanded host
    # whose name starts with the prefix); unpinned hosts classify
    # per-packet by socket slot
    overrides: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "QdiscOptions":
        _check_fields(
            "qdisc", d,
            {"discipline", "rank", "queue_slots", "buckets", "bucket_width",
             "classes", "weights", "shaping", "drop", "red_min_frac",
             "red_max_frac", "red_max_p", "overrides"},
        )
        out = cls()
        if "discipline" in d:
            v = str(d["discipline"]).lower()
            if v not in ("fifo", "roundrobin", "pifo", "eiffel"):
                raise ConfigError(
                    f"qdisc.discipline must be fifo|roundrobin|pifo|eiffel, "
                    f"got {v!r}"
                )
            out.discipline = v
        if "rank" in d:
            v = str(d["rank"]).lower()
            if v not in ("fifo", "prio", "wfq"):
                raise ConfigError(
                    f"qdisc.rank must be fifo|prio|wfq, got {v!r}"
                )
            out.rank = v
        for k in ("queue_slots", "buckets", "bucket_width", "classes"):
            if k in d:
                setattr(out, k, int(d[k]))
        if out.queue_slots < 1:
            raise ConfigError("qdisc.queue_slots must be >= 1")
        if out.buckets < 2:
            raise ConfigError("qdisc.buckets must be >= 2")
        if out.bucket_width < 1:
            raise ConfigError("qdisc.bucket_width must be >= 1")
        if out.classes < 1:
            raise ConfigError("qdisc.classes must be >= 1")
        if d.get("weights") is not None:
            out.weights = [float(w) for w in d["weights"]]
            if len(out.weights) != out.classes:
                raise ConfigError(
                    f"qdisc.weights length {len(out.weights)} != classes "
                    f"{out.classes}"
                )
            if any(w <= 0 for w in out.weights):
                raise ConfigError("qdisc.weights must be > 0")
        for c, bw in (d.get("shaping") or {}).items():
            ci = int(c)
            if not (0 <= ci < out.classes):
                raise ConfigError(
                    f"qdisc.shaping class {ci} out of range [0, "
                    f"{out.classes})"
                )
            out.shaping[ci] = units.parse_bits(bw)
        if "drop" in d:
            v = str(d["drop"]).lower()
            if v not in ("none", "red", "codel"):
                raise ConfigError(
                    f"qdisc.drop must be none|red|codel, got {v!r}"
                )
            out.drop = v
        for k in ("red_min_frac", "red_max_frac", "red_max_p"):
            if k in d:
                setattr(out, k, float(d[k]))
        if not (0.0 <= out.red_min_frac < out.red_max_frac <= 1.0):
            raise ConfigError(
                "qdisc red thresholds need "
                "0 <= red_min_frac < red_max_frac <= 1"
            )
        if not (0.0 < out.red_max_p <= 1.0):
            raise ConfigError("qdisc.red_max_p must be in (0, 1]")
        for prefix, c in (d.get("overrides") or {}).items():
            ci = int(c)
            if not (0 <= ci < out.classes):
                raise ConfigError(
                    f"qdisc.overrides[{prefix!r}] class {ci} out of range "
                    f"[0, {out.classes})"
                )
            out.overrides[str(prefix)] = ci
        if out.discipline in ("fifo", "roundrobin"):
            for k in ("rank", "drop"):
                if getattr(out, k) != cls.__dataclass_fields__[k].default:
                    raise ConfigError(
                        f"qdisc.{k} requires discipline pifo|eiffel"
                    )
        return out


@dataclasses.dataclass
class Config:
    general: GeneralOptions
    network: NetworkOptions
    experimental: ExperimentalOptions
    hosts: list[HostOptions]
    faults: FaultOptions = dataclasses.field(default_factory=FaultOptions)
    fleet: FleetOptions = dataclasses.field(default_factory=FleetOptions)
    qdisc: QdiscOptions = dataclasses.field(default_factory=QdiscOptions)
    # raw `sweep:` section, if present: expanded by shadow_tpu/fleet/sweep
    # (the `sweep` CLI subcommand); the single-run CLI refuses such files
    # with a pointer there instead of silently running only the base config
    sweep_raw: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        _check_fields(
            "config", d,
            {"general", "network", "experimental", "host_defaults", "hosts",
             "faults", "fleet", "qdisc", "sweep"},
        )
        if "general" not in d:
            raise ConfigError("general section is required")
        if "network" not in d:
            raise ConfigError("network section is required")
        general = GeneralOptions.from_dict(d["general"] or {})
        network = NetworkOptions.from_dict(d["network"] or {})
        experimental = ExperimentalOptions.from_dict(d.get("experimental") or {})
        faults = FaultOptions.from_dict(d.get("faults") or {})
        fleet = FleetOptions.from_dict(d.get("fleet") or {})
        qdisc = QdiscOptions.from_dict(d.get("qdisc") or {})
        defaults = d.get("host_defaults") or {}
        hosts: list[HostOptions] = []
        for name, hd in (d.get("hosts") or {}).items():
            hosts.extend(HostOptions.from_dict(str(name), hd or {}, defaults).expand())
        # Deterministic host ordering regardless of YAML dict order, matching
        # the reference's BTreeMap iteration (configuration.rs:75-76).
        hosts.sort(key=lambda h: h.name)
        return cls(general, network, experimental, hosts, faults, fleet,
                   qdisc, d.get("sweep"))

    def graph_gml(self) -> str:
        g = self.network.graph
        if g.type == "1_gbit_switch":
            return ONE_GBIT_SWITCH_GML
        if g.inline is not None:
            return g.inline
        assert g.path is not None
        with open(g.path) as f:
            return f.read()


def load_config(source) -> Config:
    """Load from a YAML path, file object, or string, or a raw dict."""
    if isinstance(source, dict):
        return Config.from_dict(source)
    if isinstance(source, io.IOBase):
        return Config.from_dict(yaml.safe_load(source))
    text = str(source)
    if "\n" in text or text.strip().startswith("{"):
        return Config.from_dict(yaml.safe_load(text))
    with open(text) as f:
        return Config.from_dict(yaml.safe_load(f))
