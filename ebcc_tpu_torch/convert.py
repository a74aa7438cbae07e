"""Configuration carried across from the JAX package.

The codec has no learned weights: what crosses between ``ebcc_tpu`` and the
port is the configuration and the stream bytes (ETPU, docs/FORMAT.md, which
both packages read and write).  These helpers build the port's
``CodecConfig`` and ``EncodeOptions`` from the JAX package's instances passed
as plain values (``dataclasses.asdict(...)``), so the port never imports the
JAX package.  An unknown or missing field raises: the two copies of
``config.py`` must stay field-for-field equal, except for the options
that only the JAX package has (its u16 upload): off, they carry across as
nothing; on, they raise.
"""

from __future__ import annotations

import dataclasses

from .config import CodecConfig, EncodeOptions


def _build(cls, fields: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    missing = names - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**fields)


def config_from_reference(fields: dict) -> CodecConfig:
    """Port ``CodecConfig`` from ``dataclasses.asdict(ebcc_tpu.CodecConfig)``."""
    return _build(CodecConfig, fields)


def options_from_reference(fields: dict) -> EncodeOptions:
    """Port ``EncodeOptions`` from ``dataclasses.asdict(ebcc_tpu.EncodeOptions)``."""
    names = {f.name for f in dataclasses.fields(EncodeOptions)}
    on = sorted(k for k in set(fields) - names if fields[k])
    if on:
        raise ValueError(f"EncodeOptions: the port has no {on}")
    return _build(EncodeOptions,
                  {k: v for k, v in fields.items() if k in names})
