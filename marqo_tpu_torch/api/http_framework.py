"""Minimal HTTP framework on the Python standard library.

The reference serves FastAPI/uvicorn; this image ships neither, so the
framework layer is ours: a router with `{param}` path captures, pydantic v2
request-model binding, the reference's error envelope
(``message/code/type/link``, api.py:152-157), per-request telemetry
injection (``?telemetry=true``), and a threaded stdlib HTTP server. The
route table itself lives in api/app.py.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import pydantic

from marqo_tpu_torch.api import exceptions as api_exceptions
from marqo_tpu_torch.api.telemetry import RequestMetricsStore
from marqo_tpu_torch.exceptions import MarqoError
from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)


class Request:
    def __init__(self, method: str, path: str, path_params: Dict[str, str],
                 query: Dict[str, List[str]], body: Optional[Any],
                 headers: Dict[str, str]):
        self.method = method
        self.path = path
        self.path_params = path_params
        self.query = query
        self.body = body
        self.headers = headers

    def query_param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        values = self.query.get(name)
        return values[0] if values else default

    def query_flag(self, name: str, default: bool = False) -> bool:
        value = self.query_param(name)
        if value is None:
            return default
        return value.lower() in ("true", "1", "yes")


class Response:
    def __init__(self, status: int, body: Any, headers: Optional[dict] = None):
        self.status = status
        self.body = body
        self.headers = headers or {}


class Route:
    _PARAM_RE = re.compile(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}")

    def __init__(self, method: str, pattern: str, handler: Callable):
        self.method = method.upper()
        self.pattern = pattern
        regex = self._PARAM_RE.sub(r"(?P<\1>[^/]+)", pattern)
        self.regex = re.compile(f"^{regex}$")
        self.handler = handler

    def match(self, method: str, path: str) -> Optional[Dict[str, str]]:
        if method.upper() != self.method:
            return None
        m = self.regex.match(path)
        if not m:
            return None
        from urllib.parse import unquote
        return {k: unquote(v) for k, v in m.groupdict().items()}


def error_envelope(exc: api_exceptions.MarqoWebError) -> Tuple[int, dict]:
    return exc.status_code, exc.to_body()


class App:
    """Router + dispatcher (role of the FastAPI ``app`` object)."""

    def __init__(self, title: str = "marqo-tpu"):
        self.title = title
        self.routes: List[Route] = []
        # ordered core→API mapping (reference api.py:88-141)
        self.exception_mappers: List[Tuple[type, Callable[[Exception],
                                                          Exception]]] = []

    def add_route(self, method: str, pattern: str, handler: Callable) -> None:
        self.routes.append(Route(method, pattern, handler))

    def get(self, pattern):
        return lambda fn: (self.add_route("GET", pattern, fn), fn)[1]

    def post(self, pattern):
        return lambda fn: (self.add_route("POST", pattern, fn), fn)[1]

    def patch(self, pattern):
        return lambda fn: (self.add_route("PATCH", pattern, fn), fn)[1]

    def delete(self, pattern):
        return lambda fn: (self.add_route("DELETE", pattern, fn), fn)[1]

    def map_exception(self, exc_type: type, mapper: Callable) -> None:
        self.exception_mappers.append((exc_type, mapper))

    def _translate_exception(self, exc: Exception) -> api_exceptions.MarqoWebError:
        if isinstance(exc, api_exceptions.MarqoWebError):
            return exc
        for exc_type, mapper in self.exception_mappers:
            if isinstance(exc, exc_type):
                return mapper(exc)
        if isinstance(exc, pydantic.ValidationError):
            return api_exceptions.ValidationError(_format_validation_error(exc))
        # dispatch already logged the original exception with exc_info;
        # an UNMAPPED MarqoError's message must NOT reach the client
        # (reference api.py:137-140: "This should abstract away internal
        # error", test_base_exception_handler_unhandled_error)
        return api_exceptions.InternalError(
            "Marqo encountered an unexpected internal error.")

    def dispatch(self, method: str, raw_path: str, body_bytes: bytes,
                 headers: Dict[str, str]) -> Response:
        parsed = urlparse(raw_path)
        path = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query)

        body = None
        if body_bytes:
            try:
                body = json.loads(body_bytes)
            except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
                # UnicodeDecodeError: non-UTF8 bytes (found by fuzzing) —
                # must produce the same envelope as broken JSON
                return Response(
                    400, api_exceptions.BadRequestError(
                        "Request body is not valid JSON").to_body())

        for route in self.routes:
            params = route.match(method, path)
            if params is None:
                continue
            request = Request(method, path, params, query, body, headers)
            metrics = RequestMetricsStore.set_in_request(
                traced=request.query_flag("telemetry"))
            try:
                with metrics.time("wholeRequest"):
                    result = route.handler(request)
                if isinstance(result, Response):
                    response = result
                else:
                    response = Response(200, result)
                if request.query_flag("telemetry") and \
                        isinstance(response.body, dict):
                    response.body = dict(response.body)
                    # Empty sections pruned before injection (reference
                    # telemetry.py:199-204); json() itself keeps both keys.
                    telemetry = metrics.json()
                    for section in ("timesMs", "counter"):
                        if not telemetry[section]:
                            telemetry.pop(section)
                    response.body["telemetry"] = telemetry
                return response
            except Exception as exc:
                # every handler exception is logged with its stack trace
                # BEFORE translation, 4xx included (reference
                # api/route.py:19-23 MarqoCustomRoute)
                logger.error(str(exc), exc_info=True)
                web_error = self._translate_exception(exc)
                status, envelope = error_envelope(web_error)
                return Response(status, envelope)
            finally:
                RequestMetricsStore.clear()

        # path matched no route: distinguish 404 vs 405
        allowed = [r.method for r in self.routes
                   if r.regex.match(path)]
        if allowed:
            return Response(405, {"message": f"Method {method} not allowed",
                                  "code": "method_not_allowed",
                                  "type": "invalid_request", "link": ""})
        return Response(404, {"message": f"Path {path} not found",
                              "code": "not_found",
                              "type": "invalid_request", "link": ""})


def _format_validation_error(exc: pydantic.ValidationError) -> str:
    parts = []
    for err in exc.errors():
        loc = ".".join(str(p) for p in err.get("loc", ()))
        parts.append(f"{loc}: {err.get('msg')}")
    return "; ".join(parts)


def bind_body(request: Request, model: type) -> Any:
    """Parse the JSON body into a pydantic model, surfacing validation
    errors as 422s (FastAPI behavior parity)."""
    if request.body is None:
        raise api_exceptions.BadRequestError("Request body is required")
    if not isinstance(request.body, dict):
        # FastAPI parity: a JSON array/string/number where an object model
        # is expected is a 422 validation error, not a TypeError-shaped
        # 500 (pydantic v2 models take no positional arguments)
        raise api_exceptions.ValidationError(
            f"body: Input should be a valid dictionary, got "
            f"{type(request.body).__name__}")
    try:
        return model(**request.body)
    except pydantic.ValidationError as e:
        raise api_exceptions.ValidationError(_format_validation_error(e))


class _BadRequestFraming(Exception):
    """Malformed body framing (bad Content-Length, chunked-decode error)."""


class _Handler(BaseHTTPRequestHandler):
    app: App = None  # set by serve()
    protocol_version = "HTTP/1.1"

    # refuse absurd bodies outright rather than buffering them (uvicorn
    # relies on the ASGI app for this; a stdlib server must bound reads)
    MAX_BODY_BYTES = 1 << 30

    def _read_body(self) -> bytes:
        """Body per RFC 9112 framing: Transfer-Encoding: chunked wins over
        Content-Length; a malformed/negative Content-Length is a 400, not
        a hung thread (rfile.read(-n) blocks to EOF) or a raw socket
        close with no response."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            chunks = []
            total = 0
            while True:
                size_line = self.rfile.readline(64).strip()
                try:
                    size = int(size_line.split(b";")[0], 16)
                except ValueError:
                    raise _BadRequestFraming("Malformed chunk size")
                if size == 0:
                    # consume trailer section up to the blank line
                    while self.rfile.readline(1024).strip():
                        pass
                    return b"".join(chunks)
                total += size
                if total > self.MAX_BODY_BYTES:
                    raise _BadRequestFraming("Request body too large")
                chunk = self.rfile.read(size)
                if len(chunk) < size:
                    raise _BadRequestFraming("Truncated chunk")
                chunks.append(chunk)
                self.rfile.read(2)  # CRLF after each chunk
        raw = self.headers.get("Content-Length")
        if raw is None:
            return b""
        try:
            length = int(raw)
        except ValueError:
            raise _BadRequestFraming(f"Invalid Content-Length: {raw!r}")
        if length < 0:
            raise _BadRequestFraming(f"Invalid Content-Length: {raw!r}")
        if length > self.MAX_BODY_BYTES:
            raise _BadRequestFraming("Request body too large")
        return self.rfile.read(length) if length else b""

    def _handle(self, method: str):
        try:
            body = self._read_body()
        except _BadRequestFraming as e:
            payload = json.dumps({
                "message": str(e), "code": "bad_request",
                "type": "invalid_request", "link": ""}).encode()
            self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            # framing is broken (unknown remaining body bytes): the
            # connection cannot be reused safely
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(payload)
            self.close_connection = True
            return
        response = self.app.dispatch(method, self.path, body,
                                     dict(self.headers))
        payload = json.dumps(response.body).encode()
        self.send_response(response.status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in response.headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PATCH(self):
        self._handle("PATCH")

    def do_DELETE(self):
        self._handle("DELETE")

    def log_message(self, fmt, *args):  # route through our logger
        logger.debug("%s - %s" % (self.address_string(), fmt % args))


def serve(app: App, host: str = "0.0.0.0", port: int = 8882,
          background: bool = False,
          reuse_port: bool = False) -> ThreadingHTTPServer:
    """Run the HTTP server (reference serves on :8882, run_marqo.sh).
    ``reuse_port`` binds with SO_REUSEPORT so multiple worker processes
    share one port (kernel load-balances accepts)."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    if reuse_port:
        import socket

        class _ReusePortServer(ThreadingHTTPServer):
            def server_bind(self):
                self.socket.setsockopt(socket.SOL_SOCKET,
                                       socket.SO_REUSEPORT, 1)
                super().server_bind()

        server = _ReusePortServer((host, port), handler)
    else:
        server = ThreadingHTTPServer((host, port), handler)
    logger.info(f"{app.title} listening on {host}:{port}")
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server
