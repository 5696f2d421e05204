"""Per-host packet capture in standard pcap format.

Parity: reference `src/main/utility/pcap_writer.rs` + `PcapConfig`
(`host.rs:279-282`): each enabled host writes one pcap file per interface;
simulated packets are serialized with synthetic Ethernet/IPv4/TCP|UDP
headers so wireshark/tcpdump open them directly. The capture-size option
truncates stored payload bytes (snaplen semantics).
"""

from __future__ import annotations

import ipaddress
import struct
from typing import BinaryIO

from ..net.packet import Packet, Protocol

PCAP_MAGIC = 0xA1B2C3D4  # microsecond-resolution classic format
LINKTYPE_ETHERNET = 1


def _ip(addr: str) -> bytes:
    return ipaddress.IPv4Address(addr).packed


class PcapWriter:
    def __init__(self, fh: BinaryIO, capture_size: int = 65535):
        self._fh = fh
        self._snaplen = capture_size
        fh.write(
            struct.pack(
                "<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, capture_size, LINKTYPE_ETHERNET
            )
        )

    def record(self, packet: Packet, time_ns: int) -> None:
        frame = self._serialize(packet)
        orig_len = len(frame)
        if orig_len > self._snaplen:
            frame = frame[: self._snaplen]
        sec, rem = divmod(time_ns, 1_000_000_000)
        self._fh.write(struct.pack("<IIII", sec, rem // 1000, len(frame), orig_len))
        self._fh.write(frame)

    def close(self) -> None:
        self._fh.close()

    # -- serialization ---------------------------------------------------

    def _serialize(self, p: Packet) -> bytes:
        if p.protocol == Protocol.TCP:
            l4 = self._tcp_header(p) + p.payload
            proto = 6
        else:
            l4 = self._udp_header(p) + p.payload
            proto = 17
        ip_len = 20 + len(l4)
        ip = struct.pack(
            ">BBHHHBBH4s4s",
            0x45, 0, ip_len, 0, 0, 64, proto, 0, _ip(p.src[0]), _ip(p.dst[0]),
        )
        eth = b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00"
        return eth + ip + l4

    @staticmethod
    def _tcp_header(p: Packet) -> bytes:
        h = p.header
        seq = h.seq if h else 0
        ack = h.ack if h else 0
        flags = h.flags if h else 0
        window = min(h.window if h else 0, 0xFFFF)
        return struct.pack(
            ">HHIIBBHHH",
            p.src[1], p.dst[1], seq, ack, 5 << 4, int(flags), window, 0, 0,
        )

    @staticmethod
    def _udp_header(p: Packet) -> bytes:
        return struct.pack(
            ">HHHH", p.src[1], p.dst[1], 8 + len(p.payload), 0
        )
