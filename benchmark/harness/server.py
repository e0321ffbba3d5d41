"""The program under test: the port's HTTP app on a free localhost port in
this process (``build_app``, ``generate_config``, ``on_start``,
``serve``), with every directory it writes under this run's own
directories.
"""

import http.client
import json
import os


def environment(checkout: str, workdir: str, extra: dict) -> None:
    """Sets the program's environment before it is imported: no models
    preloaded, nothing fetched, no JAX through transformers, the kernel
    caches at fixed paths inside the checkout, and the hub's cache under
    this run's directory."""
    build = os.path.join(checkout, "build")
    os.environ.update({
        "MARQO_MODELS_TO_PRELOAD": "[]",
        "MARQO_PATCH_MODELS_TO_PRELOAD": "[]",
        "MARQO_LOG_LEVEL": "warning",
        "HF_HUB_OFFLINE": "1",
        "TRANSFORMERS_OFFLINE": "1",
        "USE_FLAX": "0",
        "USE_TF": "0",
        "USE_JAX": "0",
        "HF_HOME": os.path.join(workdir, "hf"),
        "TRITON_CACHE_DIR": os.path.join(build, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
        "NO_PROXY": "127.0.0.1,localhost",
        "no_proxy": "127.0.0.1,localhost",
    })
    os.environ.update(extra)


def request(port: int, method: str, path: str, body=None,
            timeout: float = 600.0):
    """(status, decoded JSON) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        raw = response.read()
        return response.status, (json.loads(raw) if raw else None)
    finally:
        conn.close()


class Server:
    def __init__(self):
        from marqo_tpu_torch.api.app import build_app, generate_config, on_start
        from marqo_tpu_torch.api.http_framework import serve
        self.config = generate_config()
        on_start(self.config)
        self.server = serve(build_app(self.config), host="127.0.0.1", port=0,
                            background=True)
        self.port = self.server.server_address[1]

    def call(self, method: str, path: str, body=None):
        status, answer = request(self.port, method, path, body)
        if status >= 400:
            raise RuntimeError(f"{method} {path}: {status} {answer}")
        return answer

    def engine_name(self, index: str) -> str:
        """The engine's name of an index (its schema name)."""
        return self.config.index_management.get_index(index).schema_name

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
