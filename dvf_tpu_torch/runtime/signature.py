"""Canonical serving signatures: the multi-tenant bucketing key (port
of ``dvf_tpu.runtime.signature``; host code only).

A serving signature is the triple ``(op_chain, geometry, dtype)`` — what
one compiled device program can serve. Everything that keys on a
signature (the frontend's bucket map, the compiled-program pool, the
persistent compilation cache, the fleet's warm-replica preference) MUST
agree on spelling, or equal programs miss each other: ``uint8`` vs
``u8``, ``(16, 24, 3)`` vs ``[16, 24, 3]``, ``gaussian_blur(sigma=2,
ksize=9)`` vs ``gaussian_blur(ksize=9, sigma=2.0)`` are all the same
program, and a pool/cache keyed on raw client spellings would recompile
each of them. This module states the canonical form ONCE:

- **dtype**: numpy's canonical name via ``np.dtype``, with the ML
  shorthand aliases (``u8``→uint8, ``f32``→float32, ``bf16``→bfloat16 …)
  resolved FIRST — numpy itself reads ``'u8'`` as an 8-BYTE unsigned
  (uint64), which is never what a video client means.
- **geometry**: a tuple of python ints, whatever sequence type (list,
  tuple, np.shape) the client passed.
- **op_chain**: a ``|``-separated chain of registry filter specs, each
  ``name`` or ``name(k=v, ...)``, re-rendered with sorted kwargs and
  normalized numeric literals (``2`` ≡ ``2.0`` only when the value IS
  integral — filter factories receive the parsed python value, so the
  canonical string and the built filter can't diverge).

``build_filter`` turns the canonical chain into a live
:class:`~dvf_tpu_torch.api.filter.Filter` through the ops registry — the
factory the frontend's bucket admission and the ``--precompile``
manifest both compile through.
"""

from __future__ import annotations

import ast
import re
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

# ML-shorthand dtype spellings (bits, not numpy's byte-width codes:
# numpy parses "u8" as uint64). Resolved before np.dtype sees the string.
DTYPE_ALIASES = {
    "u8": "uint8", "u16": "uint16", "u32": "uint32",
    "i8": "int8", "i16": "int16", "i32": "int32",
    "f16": "float16", "f32": "float32", "f64": "float64",
    "bf16": "bfloat16", "half": "float16", "float": "float32",
    "byte": "uint8",
}

_STEP_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:\((.*)\))?\s*$",
                      re.DOTALL)


def canonical_dtype(dtype: Any) -> np.dtype:
    """One np.dtype per spelling family (``u8`` ≡ ``uint8`` ≡
    ``np.uint8``). bfloat16 (no numpy scalar on some stacks) stays a
    string-named dtype when ml_dtypes is absent."""
    if dtype is None:
        return np.dtype(np.uint8)
    if isinstance(dtype, str):
        dtype = DTYPE_ALIASES.get(dtype.strip().lower(), dtype.strip().lower())
        if dtype == "bfloat16":
            try:
                import ml_dtypes

                return np.dtype(ml_dtypes.bfloat16)
            except ImportError:
                pass  # np.dtype("bfloat16") raises below on old numpy —
                #   callers on such stacks can't run bf16 anyway
    return np.dtype(dtype)


def canonical_geometry(geometry: Sequence[int]) -> Tuple[int, ...]:
    """Any int sequence → a plain int tuple (list ≡ tuple ≡ np shape)."""
    out = tuple(int(d) for d in geometry)
    if any(d <= 0 for d in out):
        raise ValueError(f"geometry must be positive, got {out}")
    return out


def _render_value(v: Any) -> str:
    """Canonical literal for one filter kwarg value."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        # 2.0 and 2 are the same factory argument numerically, but only
        # when integral — render integral floats as ints so the spelling
        # can't fork the key.
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, str):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_render_value(x) for x in v) + "]"
    return repr(v)


def _parse_value(text: str) -> Any:
    """One kwarg literal: python literals first, bare words as strings
    (``impl=jnp`` reads naturally in a CLI spec)."""
    text = text.strip()
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        return text


def _split_args(body: str) -> List[str]:
    """Split a kwargs body on top-level commas (bracket-aware, so
    list-valued kwargs survive)."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    return [p for p in (x.strip() for x in parts) if p]


def parse_op_chain(spec: str) -> List[Tuple[str, dict]]:
    """``"a|b(k=v)"`` → ``[("a", {}), ("b", {"k": v})]``.

    Raises ValueError on malformed steps — admission surfaces that as a
    refusal, not a geometry fault three layers later.
    """
    steps: List[Tuple[str, dict]] = []
    for raw in str(spec).split("|"):
        m = _STEP_RE.match(raw)
        if m is None or not raw.strip():
            raise ValueError(f"malformed op-chain step {raw!r} in {spec!r}")
        name, body = m.group(1), m.group(2)
        kwargs: dict = {}
        if body is not None and body.strip():
            for part in _split_args(body):
                if "=" not in part:
                    raise ValueError(
                        f"op-chain step {raw!r}: positional args are not "
                        f"canonical; use k=v")
                k, v = part.split("=", 1)
                kwargs[k.strip()] = _parse_value(v)
        steps.append((name.strip(), kwargs))
    return steps


def canonical_op_chain(spec: Union[str, Sequence]) -> str:
    """Canonical rendering of an op-chain spec.

    Accepts the spec string or an already-parsed ``[(name, kwargs)]``
    list. Whitespace, kwarg order, and numeric spellings normalize away;
    two specs that build the same filters render identically.
    """
    steps = parse_op_chain(spec) if isinstance(spec, str) else [
        (name, dict(kwargs or {})) for name, kwargs in spec]
    rendered = []
    for name, kwargs in steps:
        if kwargs:
            body = ",".join(f"{k}={_render_value(kwargs[k])}"
                            for k in sorted(kwargs))
            rendered.append(f"{name}({body})")
        else:
            rendered.append(name)
    return "|".join(rendered)


class SignatureKey(NamedTuple):
    """The canonical ``(op_chain, geometry, dtype)`` serving signature.

    ``dtype`` is stored as its canonical NAME (string) so keys hash,
    compare, pickle, and render identically across processes — a
    np.dtype member would compare fine but pickle as a richer object
    than the fleet's wire needs.
    """

    op_chain: str
    geometry: Tuple[int, ...]
    dtype: str

    def render(self) -> str:
        """Human/label form: ``invert|16x24x3|uint8`` (also the stats
        bucket key and the ``bucket=`` metric label value)."""
        dims = "x".join(str(d) for d in self.geometry)
        return f"{self.op_chain}|{dims}|{self.dtype}"

    @property
    def np_dtype(self) -> np.dtype:
        return canonical_dtype(self.dtype)


def make_key(op_chain: Union[str, Sequence], geometry: Sequence[int],
             dtype: Any = None) -> SignatureKey:
    """THE canonicalization entry point: every spelling of one signature
    maps to one key (unit-pinned by tests/test_multitenant.py)."""
    return SignatureKey(
        op_chain=canonical_op_chain(op_chain),
        geometry=canonical_geometry(geometry),
        dtype=canonical_dtype(dtype).name,
    )


def build_filter(op_chain: Union[str, Sequence]):
    """Canonical chain spec → one live Filter through the ops registry
    (FilterChain when the spec has >1 step — still ONE fused device
    program, exactly like the single-filter path)."""
    from dvf_tpu_torch.api.filter import FilterChain
    from dvf_tpu_torch.ops import get_filter

    steps = parse_op_chain(op_chain) if isinstance(op_chain, str) else [
        (name, dict(kwargs or {})) for name, kwargs in op_chain]
    members = [get_filter(name, **kwargs) for name, kwargs in steps]
    if len(members) == 1:
        return members[0]
    return FilterChain(*members)


def parse_manifest(doc: Any) -> List[dict]:
    """``--precompile`` manifest → normalized entry list.

    Accepted shapes (documented in docs/GUIDE.md "Serving a mixed
    workload"): a JSON list of entries, or ``{"signatures": [...]}``.
    Each entry: ``{"op_chain": str, "frame_shape": [H, W, C],
    "dtype": str (optional, default uint8)}``. Returns entries with a
    canonical ``key`` (SignatureKey) attached.
    """
    if isinstance(doc, dict):
        doc = doc.get("signatures", [])
    if not isinstance(doc, (list, tuple)):
        raise ValueError(
            "precompile manifest must be a list of signature entries or "
            "{'signatures': [...]}")
    out: List[dict] = []
    for i, entry in enumerate(doc):
        if not isinstance(entry, dict) or "op_chain" not in entry \
                or "frame_shape" not in entry:
            raise ValueError(
                f"manifest entry {i} needs 'op_chain' and 'frame_shape', "
                f"got {entry!r}")
        key = make_key(entry["op_chain"], entry["frame_shape"],
                       entry.get("dtype"))
        out.append({"op_chain": key.op_chain,
                    "frame_shape": key.geometry,
                    "dtype": key.dtype,
                    "key": key})
    return out


def canonical_op_chain_or_verbatim(name: Any) -> str:
    """Best-effort canonicalization for op-chain spellings that may not
    be registry specs: a parseable chain canonicalizes, an ad-hoc
    filter display name (e.g. a CONFIGURED filter resolved to its
    measured impl) is kept verbatim — still a stable, equal-compares
    key. Every surface that keys on a chain spelling it did not build
    itself (the frontend's default bucket, the fleet's warm map, the
    engine's pool key) MUST share this one fallback rule, or their keys
    diverge and equal programs miss the pool/cache by spelling."""
    try:
        return canonical_op_chain(name)
    except ValueError:
        return str(name)


def engine_signature_key(engine) -> Optional[SignatureKey]:
    """The canonical signature of a compiled Engine: its filter's
    op-chain spelling (best-effort canonicalized — a registry-built name
    like ``gaussian_blur(ksize=9)`` parses; an ad-hoc name is kept
    verbatim), per-frame geometry, and dtype. None before compile."""
    sig = engine.signature
    if sig is None:
        return None
    (batch_shape, dtype) = sig
    chain = canonical_op_chain_or_verbatim(engine.op_chain)
    return SignatureKey(chain, canonical_geometry(batch_shape[1:]),
                        canonical_dtype(dtype).name)
