"""Top-level simulation builder: Config → runnable Simulation.

The JAX package's ``sim.py:build_simulation`` for PHOLD and the UDP
network stack (``udp_flood``, ``udp_echo``): load the topology, attach
and register the hosts, bake the paths, and build a ``Simulation`` whose
window step runs on the device. Other app models and the engine options
the port does not have yet raise ``BuildError`` naming their
``ROADMAP.md`` queue item.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from shadow_tpu_torch.core import simtime, units
from shadow_tpu_torch.core.config import Config, load_config
from shadow_tpu_torch.core.engine import Simulation
from shadow_tpu_torch.core.state import NetParams, resolve_device
from shadow_tpu_torch.net.apps import PholdApp, UdpEchoApp, UdpFloodApp
from shadow_tpu_torch.routing.dns import Dns
from shadow_tpu_torch.routing.topology import BakedPaths, Topology


class BuildError(ValueError):
    pass


def _refuse_unported(cfg: Config) -> None:
    x = cfg.experimental
    unported = [
        (x.num_shards > 1, "islands (num_shards > 1)", "A 9"),
        (x.pool_gears != 1, "pool gears (pool_gears != 1)", "A 6"),
        (x.flight_recorder > 0, "the flight recorder", "A 8"),
        (not x.obs_counters or not x.audit_digest,
         "running without the obs block and audit chain", "A 8"),
        (any(h.cpu_ns_per_event for h in cfg.hosts),
         "the CPU model (cpu_ns_per_event)", "A 4"),
        (x.packet_trails, "packet trails (packet_trails)", "A 7"),
    ]
    for bad, what, item in unported:
        if bad:
            raise BuildError(f"{what} is not ported to shadow_tpu_torch yet "
                             f"(ROADMAP.md queue {item})")


def _qdisc_discipline(cfg: Config):
    """The egress discipline of the ``qdisc:`` section (or the legacy
    ``experimental.interface_qdisc`` string): fifo and roundrobin; pifo
    and eiffel raise."""
    from shadow_tpu_torch.net import qdisc as qdisc_mod

    q = cfg.qdisc.discipline
    eff = q if q != "fifo" else cfg.experimental.interface_qdisc
    return qdisc_mod.make_discipline(eff)


def build_simulation(source, device=None) -> Simulation:
    """Build from a Config, YAML path/string, or dict. ``device=None`` means
    the card and raises where there is none; pass ``device="cpu"`` to run
    on the CPU."""
    dev = resolve_device(device)
    cfg = source if isinstance(source, Config) else load_config(source)
    if not cfg.hosts:
        raise BuildError("no hosts configured")
    app_names = {h.app_model for h in cfg.hosts if h.app_model}
    unknown = app_names - {"phold", "udp_flood", "udp_echo", "tcp_bulk"}
    if unknown:
        raise BuildError(f"unknown app model(s): {sorted(unknown)}")
    if "tcp_bulk" in app_names:
        raise BuildError(
            "app model tcp_bulk: TCP is not ported to shadow_tpu_torch yet "
            "(ROADMAP.md queue A 7, device function B11)")
    if len(app_names) != 1:
        raise BuildError(
            f"app models {sorted(app_names)}: one app model per simulation, "
            f"run by every host (managed processes are ROADMAP.md queue "
            f"A 12)")
    _refuse_unported(cfg)

    topo = Topology.from_gml(cfg.graph_gml(), cfg.network.use_shortest_path)
    dns = Dns()
    for i, h in enumerate(cfg.hosts):
        topo.attach_host(
            i,
            ip_address_hint=h.ip_address_hint,
            city_code_hint=h.city_code_hint,
            country_code_hint=h.country_code_hint,
            network_node_id=h.network_node_id,
        )
        dns.register(i, h.name, h.ip_address_hint)
    baked: BakedPaths = topo.bake()
    latency_vv = np.asarray(baked.latency_vv)
    params = NetParams(
        latency_vv=torch.as_tensor(latency_vv, dtype=torch.int64,
                                   device=dev),
        reliability_vv=torch.as_tensor(np.asarray(baked.reliability_vv),
                                       dtype=torch.float32, device=dev),
        bootstrap_end=int(cfg.general.bootstrap_end_time),
        vertex_g=(
            torch.as_tensor(np.asarray(baked.host_vertex),
                            dtype=torch.int32, device=dev)
            if latency_vv.shape[0] > 1 else None
        ),
    )
    runahead = cfg.experimental.runahead or baked.min_latency_ns
    if runahead > baked.min_latency_ns:
        warnings.warn(
            f"runahead {runahead}ns exceeds min topology latency "
            f"{baked.min_latency_ns}ns: cross-host events inside a window "
            f"may be processed one window late (accuracy/speed tradeoff)",
            stacklevel=2,
        )
    x = cfg.experimental
    common = dict(
        num_hosts=len(cfg.hosts), params=params,
        host_vertex=baked.host_vertex, seed=cfg.general.seed,
        stop_time=cfg.general.stop_time, runahead=runahead,
        event_capacity=x.event_capacity, K=x.events_per_host_per_window,
        B=x.inbox_slots, O=x.outbox_slots, device=dev,
    )
    if "phold" in app_names:
        sim, app = _build_phold(cfg, baked, common)
    else:
        sim, app = _build_stack(cfg, baked, common, next(iter(app_names)))
    sim.config = cfg
    sim.topology = topo
    sim.dns = dns
    sim.baked = baked
    sim.app = app
    return sim


def _build_phold(cfg: Config, baked: BakedPaths, common: dict):
    H = common["num_hosts"]
    phold_hosts = cfg.hosts
    distinct = {tuple(sorted(h.app_options.items())) for h in phold_hosts}
    if len(distinct) > 1:
        raise BuildError(
            "phold app_options must be identical across all hosts "
            "(per-host options are not supported yet)"
        )
    opts = phold_hosts[0].app_options
    app = PholdApp(
        H,
        msgload=int(opts.get("msgload", 1)),
        size_bytes=int(opts.get("size", 64)),
        start_time=units.parse_time_ns(opts.get("start_time", 1)),
        runtime=units.parse_time_ns(opts.get("runtime", 5)),
        hot_frac=float(opts.get("hot_frac", 0.0)),
        hot_share=float(opts.get("hot_share", 0.0)),
        local_span=int(opts.get("local_span", 0)),
    )
    bulk_kinds = app.bulk_kinds()
    ((bulk_kind, width),) = bulk_kinds.items()
    outbox = common["O"]
    if width > outbox:
        # the JAX package refuses this shape when it builds its window step
        # (one emission per PHOLD event, a bulk batch of `width` events)
        raise BuildError(
            f"outbox_slots O={outbox} cannot absorb a full bulk batch "
            f"(kind {bulk_kind}: 1 emissions x G={width}); raise "
            f"outbox_slots or lower the bulk width"
        )
    # the matrix path's draw-offset arithmetic (two draws per send) needs
    # every destination reachable; otherwise every window takes the loop
    reachable = not np.any(np.asarray(baked.latency_vv) == simtime.NEVER)
    sim = Simulation(
        **common,
        handlers=app.handlers(),
        bulk_kinds=bulk_kinds,
        matrix_handler=app.handle_msg_matrix if reachable else None,
        subs={PholdApp.SUB: app.init_sub(common["device"])},
        initial_events=app.initial_events(),
        payload_words=PholdApp.PAYLOAD_WORDS,
    )
    return sim, app


def _build_stack(cfg: Config, baked: BakedPaths, common: dict, name: str):
    """The network-stack branch for ``udp_flood`` / ``udp_echo``."""
    from shadow_tpu_torch.net.stack import NetStack

    H = common["num_hosts"]
    dev = common["device"]
    roles = {}
    client_opts = None
    for i, h in enumerate(cfg.hosts):
        roles[i] = str(h.app_options.get("role", "client"))
        if roles[i] == "client":
            o = {k: v for k, v in h.app_options.items() if k != "role"}
            if client_opts is None:
                client_opts = o
            elif client_opts != o:
                raise BuildError(
                    f"{name} client app_options must be identical")
    servers = [i for i, r in roles.items() if r == "server"]
    if not servers:
        raise BuildError(f"{name} needs at least one role: server host")
    client_opts = client_opts or {}

    # per-host bandwidths: the host's own, else its vertex's
    bw_up = np.zeros(H, dtype=np.int64)
    bw_down = np.zeros(H, dtype=np.int64)
    for i, h in enumerate(cfg.hosts):
        v = baked.host_vertex[i]
        bw_up[i] = h.bandwidth_up or baked.vertex_bw_up_bits[v]
        bw_down[i] = h.bandwidth_down or baked.vertex_bw_down_bits[v]
        if bw_up[i] <= 0 or bw_down[i] <= 0:
            raise BuildError(
                f"host {h.name}: no bandwidth configured (host or graph "
                f"vertex must set bandwidth_up/down)"
            )
    x = cfg.experimental
    stack = NetStack(
        H, bw_up, bw_down,
        sockets_per_host=x.sockets_per_host,
        router_queue_slots=x.router_queue_slots,
        router_variant=x.router_queue_variant,
        discipline=_qdisc_discipline(cfg),
        payload_words=12,
        device=dev,
    )
    interval = units.parse_time_ns(client_opts.get("interval", "100 ms"),
                                   default_unit="ms")
    start = units.parse_time_ns(client_opts.get("start_time", 1))
    stop_send = (units.parse_time_ns(client_opts["runtime"]) + start
                 if "runtime" in client_opts else None)
    if name == "udp_flood":
        app = UdpFloodApp(
            H, servers, interval,
            size_bytes=int(client_opts.get("size", 1024)),
            start_time=start, stop_sending=stop_send,
            local_span=int(client_opts.get("local_span", 0)),
        )
    else:
        if len(servers) != 1:
            raise BuildError("udp_echo supports exactly one server host")
        app = UdpEchoApp(
            H, servers[0], interval,
            size_bytes=int(client_opts.get("size", 512)),
            start_time=start, stop_sending=stop_send,
        )
    app.attach(stack)
    stack.on_receive(app.on_receive)
    handlers = dict(stack.handlers())
    handlers.update(app.handlers())
    subs = stack.init_subs()
    subs[app.SUB] = app.init_sub(dev)
    bulk_kinds = stack.bulk_kinds()
    sim = Simulation(
        **common,
        handlers=handlers,
        bulk_kinds=bulk_kinds,
        bulk_gate=stack.bulk_gate if bulk_kinds else None,
        bulk_self_excluded=bulk_kinds is not None,
        subs=subs,
        initial_events=app.initial_events(),
        payload_words=12,
    )
    sim.stack = stack
    return sim, app
