"""One CUDA graph per static bucket of an encoder: the port's counterpart
of the JAX package's one compiled program per shape.

The JAX package runs each encoder as one XLA program per static bucket
shape (marqo_tpu/models/bert.py ``encode_tokens_jit``,
``encode_tokens_packed_jit`` with a static ``num_sequences``;
marqo_tpu/models/clip.py ``encode_clip_image_jit``,
``encode_clip_text_jit``, and the other CLIP families', Stella's
``encode_tokens_jit``, ``cross_encoder_scores``, DINO's
``last_selfattention_jit``, OWL-ViT's ``detect_jit``, YOLOX's and Faster
R-CNN's ``forward_jit`` and LanguageBind's audio and video towers),
compiled at a shape's first call or ahead of it by the loaders'
``warmup``, so a batch is one dispatch. Eager PyTorch instead issues
every op of every layer from Python, each kernel call through its
wrapper's checks and a ctypes call. Here a forward is captured
once per key as a ``torch.cuda.CUDAGraph`` over static input and output
tensors, and each batch replays it with one host call; the graph holds the
same kernels (B1, B2, B3 and the library's matmuls) with the pointers and
TMA maps of the capture, so every replay reads the same static inputs.

``EncoderGraphs`` holds one model's graphs, keyed by the tower's name
("padded", "packed", "text", "vision", "image", "audio", "video",
"scores", "dino", "yolox", "frcnn", "detect"), the compute
dtype, the static values the forward was built with (a config, the
packed path's sequence bucket) and every input's shape and dtype; never
by the callable, which callers pass as a new lambda each time. On a miss
it runs the forward once eagerly on a side stream (the kernel library
loads, the kernels' first launch sets their shared-memory attributes and
cuDNN picks its plans outside capture), then captures it; all graphs of a
model share one memory pool. A replay copies the
host batch into the static inputs through pinned memory, replays and
returns a clone of the static output, all under the model's lock: callers
keep several outputs pending before their one copy to the host, and
serving threads call one model at once. A capture or replay error raises;
nothing gives way to the eager forward. Only CUDA models without a
serving mesh come here (inference/batching.py ``graphs_for``), and the
patchers, the rerankers and LanguageBind on CUDA, each with graphs of
its own (``card_graphs``). A graph reads its module's weights through the
capture's pointers: a caller that assigns a module anew ``forget``s its
tower's graphs.

The launches a capture records (ops/launches.py) are added to the
kernels' counts on every replay, so the counts keep meaning launches on
the card. On a traced request (api/telemetry.py) a run of a key already
captured is the span ``inference.dispatch`` (the wait for the lock, the
copy in, the replay) and a capture ``inference.graph_capture``, counted
in ``graphs.captured``.
"""

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from marqo_tpu_torch.api import telemetry
from marqo_tpu_torch.ops import launches


class Graph:
    """One captured forward: its key, its static inputs and output, the
    call that replays it, the launches it records, and the seconds its
    warm run and capture took."""

    def __init__(self, key: tuple, inputs: List[torch.Tensor],
                 output: torch.Tensor, replay: Callable[[], None],
                 recorded: list, seconds: float):
        self.key = key
        self.inputs = inputs
        self.output = output
        self._replay = replay
        self.launches = recorded
        self.seconds = seconds

    def replay(self) -> torch.Tensor:
        """Run the graph on what its static inputs hold; a clone of its
        output."""
        self._replay()
        launches.add(self.launches)
        return self.output.clone()


class EncoderGraphs:
    """One model's CUDA graphs on ``device``. ``capture(forward, inputs)
    -> (replay, output)`` captures ``forward(*inputs)``; the default is
    ``torch.cuda.graph`` on this object's memory pool (tests inject a
    stand-in)."""

    def __init__(self, device, capture: Optional[Callable] = None):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.graphs: Dict[tuple, Graph] = {}
        self._capture = capture or self._capture_cuda
        self._pool = None

    def run(self, tower: str, dtype: torch.dtype, forward: Callable,
            *arrays: np.ndarray, static: tuple = ()) -> torch.Tensor:
        """``forward(*inputs)`` on the host ``arrays`` put on the device,
        through the graph of (tower, dtype, static, the arrays' shapes and
        dtypes), captured from ``forward`` at the key's first call."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        key = (tower, str(dtype), static,
               tuple((a.shape, a.dtype.str) for a in arrays))
        # a capture is a span of its own, not a dispatch
        span = telemetry.span("inference.dispatch") if key in self.graphs \
            else contextlib.nullcontext()
        with span, self.lock, torch.inference_mode():
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = self._build(key, forward,
                                                        arrays)
            else:
                self._fill(graph.inputs, arrays)
            return graph.replay()

    def forget(self, tower: str) -> None:
        """Drop every graph of ``tower``, once the card has run what was
        queued: for a module assigned anew, whose captures read the old
        module's weights."""
        with self.lock:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for key in [key for key in self.graphs if key[0] == tower]:
                del self.graphs[key]

    def _fill(self, inputs: Sequence[torch.Tensor], arrays) -> None:
        """Copy the host arrays into the static inputs. The staging copy is
        pinned, so the copy to the card is queued on the stream without a
        wait; the host allocator keeps the pinned block until it is done."""
        for tensor, array in zip(inputs, arrays):
            host = torch.from_numpy(array)
            if self.device.type == "cuda":
                host = host.pin_memory()
            tensor.copy_(host, non_blocking=True)

    def _build(self, key: tuple, forward: Callable, arrays) -> Graph:
        start = time.perf_counter()
        with telemetry.span("inference.graph_capture"):
            inputs = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                  device=self.device) for a in arrays]
            self._fill(inputs, arrays)
            self._warm(forward, inputs)
            with launches.recording() as recorded:
                replay, output = self._capture(forward, inputs)
        traced = telemetry.traced()
        if traced:
            traced.increment_counter("graphs.captured")
        return Graph(key, inputs, output, replay, recorded,
                     time.perf_counter() - start)

    def _warm(self, forward: Callable, inputs) -> None:
        """The forward once, eagerly: on CUDA on a side stream, as capture
        asks, so the kernel library's load and the kernels' first-launch
        attribute calls happen outside capture."""
        if self.device.type != "cuda":
            forward(*inputs)
            return
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            forward(*inputs)
        main.wait_stream(side)

    def _capture_cuda(self, forward: Callable, inputs):
        """``forward(*inputs)`` captured into a CUDA graph on the model's
        pool. Thread-local capture: other threads may launch meanwhile."""
        with torch.cuda.device(self.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                output = forward(*inputs)
        return graph.replay, output
