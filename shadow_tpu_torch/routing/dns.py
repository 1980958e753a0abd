"""Global name ↔ IP registry (reference: src/main/routing/dns.c:125-193).

Assigns each host a unique IPv4 address at setup, honoring an
``ip_address_hint`` when it is valid and unused, otherwise allocating
sequentially from 11.0.0.1 (public-range addresses, like the reference,
so managed processes never confuse simulated addresses with loopback).
Resolution backs the getaddrinfo interposition
(src/lib/shim/preload_libraries.c:292) and packet delivery addressing.
"""

from __future__ import annotations

import ipaddress


class DnsError(ValueError):
    pass


# Reserved IPv4 ranges the reference refuses to assign (dns.c:84-110,
# _dns_isRestricted): hints inside these are regenerated, and the sequential
# allocator skips them (which is why its counter lands at 11.0.0.0+).
_RESERVED_NETS = [
    ipaddress.ip_network(n)
    for n in (
        "0.0.0.0/8", "10.0.0.0/8", "100.64.0.0/10", "127.0.0.0/8",
        "169.254.0.0/16", "172.16.0.0/12", "192.0.0.0/29", "192.0.2.0/24",
        "192.88.99.0/24", "192.168.0.0/16", "198.18.0.0/15", "198.51.100.0/24",
        "203.0.113.0/24", "224.0.0.0/4", "240.0.0.0/4", "255.255.255.255/32",
    )
]


def _is_restricted(ip: int) -> bool:
    addr = ipaddress.ip_address(ip)
    return any(addr in net for net in _RESERVED_NETS)


class Dns:
    def __init__(self, base_ip: str = "11.0.0.1"):
        self._next = int(ipaddress.ip_address(base_ip))
        self._name_to_ip: dict[str, int] = {}
        self._ip_to_name: dict[int, str] = {}
        self._ip_to_host: dict[int, int] = {}

    def register(self, host_index: int, name: str, ip_hint: str | None = None) -> int:
        """Register a host; returns its assigned IPv4 as a u32."""
        if name in self._name_to_ip:
            raise DnsError(f"duplicate hostname {name!r}")
        ip = None
        if ip_hint is not None:
            want = int(ipaddress.ip_address(ip_hint))
            if want not in self._ip_to_name and not _is_restricted(want):
                ip = want
        if ip is None:
            while self._next in self._ip_to_name or _is_restricted(self._next):
                self._next += 1
            ip = self._next
            self._next += 1
        self._name_to_ip[name] = ip
        self._ip_to_name[ip] = name
        self._ip_to_host[ip] = host_index
        return ip

    def resolve_name(self, name: str) -> int | None:
        return self._name_to_ip.get(name)

    def resolve_ip(self, ip: int) -> str | None:
        return self._ip_to_name.get(ip)

    def host_for_ip(self, ip: int) -> int | None:
        return self._ip_to_host.get(ip)

    @staticmethod
    def ip_str(ip: int) -> str:
        return str(ipaddress.ip_address(ip))

    def __len__(self) -> int:
        return len(self._name_to_ip)
