"""gRPC code generation from .proto service definitions.

Parity with the reference's madsim-tonic-build (C23): the reference
forks tonic's protoc codegen to emit simulator client/server stubs from
.proto files (madsim-tonic-build/src/prost.rs:326-330, server.rs:11-128,
client.rs:10+). The analog here reads the ``service`` blocks out of a
.proto file and generates, at runtime:

  * ``<Name>Servicer`` — a base class whose methods raise UNIMPLEMENTED
    until overridden (the async_trait service trait, server.rs:144-163),
    carrying ``SERVICE_NAME = "package.Name"`` and per-method call-shape
    markers;
  * ``<Name>Client`` — a channel-bound client factory with one method
    per rpc, honoring ``stream`` on either side (client.rs generate).

Message and enum blocks are compiled too (the reference emits full prost
message types next to the sim stubs, prost.rs:326-330): each ``message``
becomes a dataclass whose fields carry the .proto types, numbers and
labels in ``__proto_fields__``, with proto3 zero-value defaults
(repeated -> list, map<k,v> -> dict, message fields -> None, enums ->
their zero variant). Inside the simulation instances travel by
reference (the BoxMessage = Box<dyn Any> design, sim.rs:27-29); on the
std backend they pickle like any payload — the same generated class is
the interface type on both sides of the cfg switch. Dicts remain
accepted everywhere for hand-rolled services.

    ns = compile_proto("proto/helloworld.proto")
    req = ns.HelloRequest(name="world")
    class MyGreeter(ns.GreeterServicer):
        async def say_hello(self, request): ...
    client = ns.GreeterClient(channel)
"""

from __future__ import annotations

import dataclasses
import keyword
import re
import types
from typing import Optional

from .grpc import Channel, Status

__all__ = ["compile_proto", "compile_proto_source"]

_PACKAGE_RE = re.compile(r"^\s*package\s+([\w.]+)\s*;", re.M)
_SERVICE_RE = re.compile(r"service\s+(\w+)\s*\{", re.M)
_MESSAGE_RE = re.compile(r"\bmessage\s+(\w+)\s*\{")
_ENUM_RE = re.compile(r"\benum\s+(\w+)\s*\{")
_RPC_RE = re.compile(
    r"rpc\s+(\w+)\s*\(\s*(stream\s+)?([\w.]+)\s*\)\s*"
    r"returns\s*\(\s*(stream\s+)?([\w.]+)\s*\)",
    re.M,
)
_FIELD_RE = re.compile(
    r"(repeated\s+|optional\s+|required\s+)?"
    r"(map\s*<\s*[\w.]+\s*,\s*[\w.]+\s*>|[\w.]+)\s+(\w+)\s*=\s*(\d+)\s*;"
)
_ENUM_VALUE_RE = re.compile(r"(\w+)\s*=\s*(-?\d+)\s*;")
_ONEOF_RE = re.compile(r"\boneof\s+\w+\s*\{")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)

# proto3 scalar zero values (prost's Default impls)
_SCALAR_DEFAULTS = {
    "double": 0.0, "float": 0.0,
    "int32": 0, "int64": 0, "uint32": 0, "uint64": 0,
    "sint32": 0, "sint64": 0, "fixed32": 0, "fixed64": 0,
    "sfixed32": 0, "sfixed64": 0,
    "bool": False, "string": "", "bytes": b"",
}


def _snake(name: str) -> str:
    """SayHello -> say_hello (tonic generates snake_case methods)."""
    out = re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name)
    return out.lower()


def _block(src: str, open_brace: int) -> str:
    """The text of a balanced {...} block starting at ``open_brace``."""
    depth = 0
    for i in range(open_brace, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return src[open_brace + 1 : i]
    raise ValueError("unbalanced braces in .proto service block")


def _shape(client_stream: bool, server_stream: bool) -> str:
    if client_stream and server_stream:
        return "bidi"
    if client_stream:
        return "client_stream"
    if server_stream:
        return "server_stream"
    return "unary"


def compile_proto_source(src: str, package: Optional[str] = None) -> types.SimpleNamespace:
    """Generate message dataclasses, enums and Servicer/Client classes
    from .proto text."""
    src = _COMMENT_RE.sub("", src)
    if package is None:
        m = _PACKAGE_RE.search(src)
        package = m.group(1) if m else ""
    ns = types.SimpleNamespace()
    for name, cls in _compile_types(src, package):
        setattr(ns, name, cls)
    for m in _SERVICE_RE.finditer(src):
        svc_name = m.group(1)
        body = _block(src, m.end() - 1)
        methods = [
            (
                _snake(rm.group(1)),
                rm.group(1),
                _shape(bool(rm.group(2)), bool(rm.group(4))),
            )
            for rm in _RPC_RE.finditer(body)
        ]
        if not methods:
            continue
        full_name = f"{package}.{svc_name}" if package else svc_name
        setattr(ns, f"{svc_name}Servicer", _make_servicer(full_name, methods))
        setattr(
            ns,
            f"{svc_name}Client",
            _make_client(full_name, svc_name, methods),
        )
    return ns


def compile_proto(path: str) -> types.SimpleNamespace:
    """Generate Servicer/Client classes from a .proto file."""
    with open(path) as fh:
        return compile_proto_source(fh.read())


# ---------------------------------------------------------------------------
# message / enum compilation
# ---------------------------------------------------------------------------

# full proto name -> generated class. Both ends of a std connection
# compile the same .proto at import time, so pickled messages restore
# through this registry (instances of runtime-generated classes can't
# pickle by module path).
_MESSAGE_REGISTRY: dict[str, type] = {}


def _restore_message(full_name: str, values: dict):
    cls = _MESSAGE_REGISTRY.get(full_name)
    if cls is None:
        raise RuntimeError(
            f"cannot unpickle proto message {full_name!r}: compile the "
            f".proto in this process first (compile_proto)"
        )
    return cls(**values)


def _collect_type_blocks(text: str, prefix: str):
    """Yield ('message'|'enum', dotted_name, body) for every (possibly
    nested) message/enum block, and return the text with those blocks
    removed (so a parent's field scan never sees nested fields)."""
    found = []

    def walk(chunk: str, pfx: str) -> str:
        while True:
            mm = _MESSAGE_RE.search(chunk)
            em = _ENUM_RE.search(chunk)
            m = min(
                (x for x in (mm, em) if x is not None),
                key=lambda x: x.start(),
                default=None,
            )
            if m is None:
                return chunk
            body = _block(chunk, m.end() - 1)
            name = (pfx + "." if pfx else "") + m.group(1)
            end = m.end() - 1 + len(body) + 2  # past the closing brace
            if m.re is _MESSAGE_RE:
                inner = walk(body, name)
                found.append(("message", name, inner))
            else:
                found.append(("enum", name, body))
            chunk = chunk[: m.start()] + chunk[end:]

    rest = walk(text, prefix)
    return found, rest


def _make_enum(name: str, body: str) -> type:
    values = {m.group(1): int(m.group(2)) for m in _ENUM_VALUE_RE.finditer(body)}
    attrs = dict(values)
    attrs["__proto_values__"] = values
    return type(name.rsplit(".", 1)[-1], (), attrs)


def _field_default(type_str: str, label: str, enums: dict):
    if label == "repeated":
        return dataclasses.field(default_factory=list)
    if type_str.startswith("map"):
        return dataclasses.field(default_factory=dict)
    if type_str in _SCALAR_DEFAULTS:
        return _SCALAR_DEFAULTS[type_str]
    short = type_str.rsplit(".", 1)[-1]
    if short in enums:
        vals = enums[short].__proto_values__
        return min(vals.values()) if vals else 0
    return None  # message-typed (or optional): absent until set


def _make_message(full_name: str, body: str, enums: dict, package: str = "") -> type:
    # oneof members are plain fields of the parent in the dataclass view
    while True:
        m = _ONEOF_RE.search(body)
        if m is None:
            break
        inner = _block(body, m.end() - 1)
        end = m.end() - 1 + len(inner) + 2
        body = body[: m.start()] + inner + body[end:]
    fields = []
    proto_fields = []
    for fm in _FIELD_RE.finditer(body):
        label = (fm.group(1) or "").strip()
        type_str = re.sub(r"\s+", "", fm.group(2))
        fname, number = fm.group(3), int(fm.group(4))
        # Python keywords can't be dataclass fields; suffix them the way
        # generated code conventionally does (prost escapes as r#from).
        # __proto_fields__ keeps the original wire name.
        py_name = fname + "_" if keyword.iskeyword(fname) else fname
        proto_fields.append((fname, number, label or "singular", type_str))
        fields.append((py_name, object, _field_default(type_str, label, enums)))
    # class name: the in-package path with dots flattened, so nested
    # messages (shop.Order.Address -> Order_Address) match their
    # namespace attribute and stay distinguishable across parents
    rel = full_name
    if package and full_name.startswith(package + "."):
        rel = full_name[len(package) + 1:]
    short = rel.replace(".", "_")
    cls = dataclasses.make_dataclass(
        short,
        fields,
        namespace={
            "__proto_fields__": tuple(proto_fields),
            "__proto_name__": full_name,
            # shallow field map: nested messages pickle through their
            # own __reduce__ (asdict would flatten them into dicts)
            "__reduce__": lambda self: (
                _restore_message,
                (
                    self.__proto_name__,
                    {
                        f.name: getattr(self, f.name)
                        for f in dataclasses.fields(self)
                    },
                ),
            ),
        },
    )
    _MESSAGE_REGISTRY[full_name] = cls
    return cls


def _compile_types(src: str, package: str):
    """Yield (attr_name, class) for every message/enum in the file."""
    blocks, _rest = _collect_type_blocks(src, "")
    enums: dict[str, type] = {}
    out = []
    for kind, name, body in blocks:
        if kind == "enum":
            cls = _make_enum(name, body)
            enums[name.rsplit(".", 1)[-1]] = cls
            out.append((name.replace(".", "_"), cls))
    for kind, name, body in blocks:
        if kind == "message":
            full = f"{package}.{name}" if package else name
            cls = _make_message(full, body, enums, package)
            out.append((name.replace(".", "_"), cls))
    return out


def _make_servicer(full_name: str, methods) -> type:
    """Base class: every rpc raises UNIMPLEMENTED until overridden
    (the generated async_trait default, server.rs:144-163)."""
    attrs = {"SERVICE_NAME": full_name}
    for py_name, proto_name, shape in methods:
        if shape in ("server_stream", "bidi"):
            # async generators so the router classifies the shape right
            # even for the unimplemented default
            async def default(self, request, _p=proto_name):  # type: ignore[misc]
                raise Status.unimplemented(_p)
                yield  # pragma: no cover - makes this an async generator

        else:

            async def default(self, request, _p=proto_name):  # type: ignore[misc]
                raise Status.unimplemented(_p)

        default.__name__ = py_name
        default.__rpc_shape__ = shape  # type: ignore[attr-defined]
        attrs[py_name] = default
    cls = type(full_name.rsplit(".", 1)[-1] + "Servicer", (), attrs)
    return cls


def _make_client(full_name: str, svc_name: str, methods) -> type:
    attrs = {}
    for py_name, proto_name, shape in methods:
        path = f"/{full_name}/{py_name}"
        if shape == "unary":

            def call(self, msg=None, timeout=None, _path=path):
                return self.channel.unary(_path, msg, timeout=timeout)

        elif shape == "server_stream":

            def call(self, msg=None, _path=path):
                return self.channel.server_streaming(_path, msg)

        elif shape == "client_stream":

            def call(self, _path=path):
                return self.channel.client_streaming(_path)

        else:

            def call(self, _path=path):
                return self.channel.bidi(_path)

        call.__name__ = py_name
        attrs[py_name] = call

    def __init__(self, channel: Channel):
        self.channel = channel

    attrs["__init__"] = __init__
    return type(f"{svc_name}Client", (), attrs)
