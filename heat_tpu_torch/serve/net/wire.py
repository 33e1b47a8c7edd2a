"""The wire schema of the network serving tier.

Counterpart of ``heat_tpu/serve/net/wire.py``, byte for byte: the same
array, envelope and trace give the same bytes in both packages, so a
router of either package reaches a replica of the other. A JSON envelope
carries each array as the **base64 of its ``.npy`` serialization**, which
is self-describing (dtype, shape, C-order bytes) and round-trips bit for
bit, so exact-mode answers survive the network hop.

Request body (``POST /v1/<endpoint>``)::

    {"payload": "<base64(npy bytes)>"}

optionally with a ``trace`` field minted at the router's ingress::

    {"payload": "...", "trace": {"id": "<hex>", "parent": "<span name>",
                                 "sampled": true}}

which :func:`decode_request` ignores (it needs only the payload key).
Sparse rows (``sparse_query`` endpoints, ``sparse.host.CsrRows``)::

    {"payload_csr": {"indptr": "<b64 npy>", "indices": "<b64 npy>",
                     "values": "<b64 npy>", "cols": <int>}}

Success (HTTP 200): ``{"ok": true, "result": "<base64(npy bytes)>"}``,
with the serving endpoint's ``"version"``. Error (4xx/5xx):
``{"ok": false, "error": "<message>", "reason": "<machine tag>"}``;
``reason`` carries the admission taxonomy (``queue_full``, ``memory``,
``draining``, ``closed``, ...) that the router's retry policy keys on.

Object arrays never travel (``allow_pickle=False`` both ways: a replica
must not unpickle bytes from the network), and a malformed envelope
raises :class:`WireError`.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Tuple

import numpy as np

__all__ = [
    "WireError",
    "encode_array",
    "decode_array",
    "encode_request",
    "decode_request",
    "decode_request_ex",
    "encode_response",
    "encode_error",
    "decode_response",
    "decode_response_version",
]


class WireError(ValueError):
    """Malformed wire envelope or payload (maps to HTTP 400)."""


def encode_array(arr: np.ndarray) -> str:
    """``base64(npy bytes)`` of ``arr`` — dtype/shape self-describing,
    bitwise round-trip (:func:`decode_array` is the inverse)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject:
        raise WireError("object-dtype arrays cannot travel on the wire")
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_array(data: str) -> np.ndarray:
    """Inverse of :func:`encode_array`; raises :class:`WireError` on
    garbage instead of leaking codec internals."""
    if not isinstance(data, str):
        raise WireError(f"payload must be a base64 string, got {type(data)}")
    try:
        raw = base64.b64decode(data.encode("ascii"), validate=True)
    except Exception as e:
        raise WireError(f"payload is not valid base64: {e}") from None
    try:
        return np.load(io.BytesIO(raw), allow_pickle=False)
    except Exception as e:
        raise WireError(f"payload is not a valid .npy blob: {e}") from None


def encode_request(payload, trace=None) -> bytes:
    """The JSON body of ``POST /v1/<endpoint>``. Dense payloads ride the
    ``payload`` envelope; :class:`~heat_tpu_torch.sparse.host.CsrRows` batches
    ride ``payload_csr``: three self-describing ``.npy`` blobs plus the
    feature width, bitwise round-trip like the dense form. ``trace`` is
    the optional trace-context dict (absent when tracing is off or the
    request is unsampled)."""
    from ...sparse.host import CsrRows

    if isinstance(payload, CsrRows):
        obj = {
            "payload_csr": {
                "indptr": encode_array(payload.indptr),
                "indices": encode_array(payload.indices),
                "values": encode_array(payload.values),
                "cols": int(payload.cols),
            }
        }
    else:
        obj = {"payload": encode_array(payload)}
    if trace is not None:
        obj["trace"] = trace
    return json.dumps(obj).encode("utf-8")


def decode_request(body: bytes):
    """Parse a request body into the payload — a dense array, or a
    :class:`~heat_tpu_torch.sparse.host.CsrRows` batch for the sparse
    envelope (server side; ``Server.submit`` accepts both). Any
    ``trace`` field is ignored here — transports that propagate tracing
    use :func:`decode_request_ex`."""
    return decode_request_ex(body)[0]


def decode_request_ex(body: bytes):
    """Parse a request body → ``(payload, trace_or_None)`` where
    ``trace`` is the raw wire dict of the trace field (``None``
    when absent or malformed — a bad trace field must never fail a
    request, it only loses the trace)."""
    try:
        obj = json.loads(body.decode("utf-8"))
    except Exception as e:
        raise WireError(f"request body is not JSON: {e}") from None
    trace = obj.get("trace") if isinstance(obj, dict) else None
    if not isinstance(trace, dict):
        trace = None
    if isinstance(obj, dict) and "payload_csr" in obj:
        csr = obj["payload_csr"]
        if not isinstance(csr, dict) or not all(
            k in csr for k in ("indptr", "indices", "values", "cols")
        ):
            raise WireError(
                'payload_csr must carry {"indptr", "indices", "values", '
                '"cols"}'
            )
        from ...sparse.host import CsrRows

        try:
            return CsrRows(
                decode_array(csr["indptr"]),
                decode_array(csr["indices"]),
                decode_array(csr["values"]),
                int(csr["cols"]),
            ), trace
        except WireError:
            raise
        except Exception as e:
            raise WireError(f"malformed CSR payload: {e}") from None
    if not isinstance(obj, dict) or "payload" not in obj:
        raise WireError('request JSON must be {"payload": "<base64 npy>"}')
    return decode_array(obj["payload"]), trace


def encode_response(result: np.ndarray, version=None) -> bytes:
    """The JSON body of a 200 response. ``version`` stamps the endpoint
    version that served the request into the envelope, so a client
    driving a rolling update can see which replicas have cut over;
    absent for peers that send none (decoders default it to None)."""
    obj = {"ok": True, "result": encode_array(result)}
    if version is not None:
        obj["version"] = int(version)
    return json.dumps(obj).encode("utf-8")


def encode_error(message: str, reason: str) -> bytes:
    """The JSON body of an error response (``reason`` is the machine
    tag the router keys its retry policy on)."""
    return json.dumps(
        {"ok": False, "error": str(message), "reason": reason}
    ).encode("utf-8")


def decode_response(body: bytes) -> Tuple[bool, object, str]:
    """Parse a response body → ``(ok, result_or_message, reason)``:
    ``(True, ndarray, "")`` on success, ``(False, message, reason)`` on a
    structured error."""
    try:
        obj = json.loads(body.decode("utf-8"))
    except Exception as e:
        raise WireError(f"response body is not JSON: {e}") from None
    if not isinstance(obj, dict) or "ok" not in obj:
        raise WireError('response JSON must carry an "ok" field')
    if obj["ok"]:
        if "result" not in obj:
            raise WireError('ok response is missing "result"')
        return True, decode_array(obj["result"]), ""
    return False, str(obj.get("error", "")), str(obj.get("reason", ""))


def decode_response_version(body: bytes):
    """The endpoint version stamped into a 200 envelope, or ``None``
    (error responses, peers that send none)."""
    try:
        obj = json.loads(body.decode("utf-8"))
    except Exception as e:
        raise WireError(f"response body is not JSON: {e}") from None
    v = obj.get("version") if isinstance(obj, dict) else None
    return int(v) if v is not None else None
