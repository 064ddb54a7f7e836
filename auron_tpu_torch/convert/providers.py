"""Pluggable conversion providers (port of ``auron_tpu/convert/providers.py``,
the reference's AuronConvertProvider SPI): providers register with the
conversion layer and are consulted for host operators the built-in
converter table does not know, as the Iceberg/Hudi/Paimon table-format
plugins are. This module, and with it the built-in table-format provider,
loads at the first lookup (``strategy.tag_plan``, ``converters``).
"""

from __future__ import annotations

from typing import Protocol

from auron_tpu_torch.convert.hostplan import HostNode
from auron_tpu_torch.utils.config import Configuration, bool_conf

TABLE_FORMATS_ENABLE = bool_conf(
    "convert.enable.table_formats", True, "convert",
    "convert table-format scans (iceberg/hudi/paimon descriptors) to native file scans",
)


class ConvertProvider(Protocol):
    def is_enabled(self, node: HostNode, conf: Configuration) -> bool: ...

    def is_supported(self, node: HostNode) -> bool: ...

    def convert(self, node: HostNode, children: list, conf: Configuration): ...


_PROVIDERS: list[ConvertProvider] = []


def register_provider(p: ConvertProvider) -> None:
    _PROVIDERS.append(p)


def find_provider(node: HostNode, conf: Configuration) -> ConvertProvider | None:
    for p in _PROVIDERS:
        if p.is_supported(node) and p.is_enabled(node, conf):
            return p
    return None


def _install_builtin_providers() -> None:
    from auron_tpu_torch.convert.table_formats import TableFormatScanProvider

    register_provider(TableFormatScanProvider())


_install_builtin_providers()
