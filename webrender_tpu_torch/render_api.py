"""RenderApi + threaded pipeline — mirrors `webrender/src/render_api.rs`
(RenderApi :1023, send_transaction :1249) and the thread model of
`renderer/init.rs:292` (create_webrender_instance): a scene-builder thread
and a render-backend thread connected by queues, with the caller's thread
acting as the render thread (the GL thread analog — it owns the Renderer's
HBM arrays).

Pipeline parallelism (SURVEY.md §2.7.1): a transaction's scene build can
overlap the previous frame's frame-build/render. Message types mirror
SceneMsg/FrameMsg/ApiMsg (render_api.rs:762/791/917) as plain tuples.

The port's copy of `webrender_tpu/render_api.py` over the port's
`RenderBackend`, on `device` (the card by default).  Only the caller's
thread touches the device: the scene builder and the backend threads run
host code alone (scene building, resource updates, frame building), and
the uploads and every raster run in `render()`.  A thread's current CUDA
device is its own, so the renderer is pinned to its card when it is made
(`Renderer`), on the caller's thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .api.color import ColorF
from .api.transaction import Transaction
from .render_backend import RenderBackend
from .scene.scene_builder import build_scene


@dataclass
class RenderNotifier:
    """webrender_api/lib.rs:261 RenderNotifier."""
    new_frame_ready: Callable[[], None] = lambda: None
    shut_down: Callable[[], None] = lambda: None


class RenderApi:
    """Client handle living on the app thread."""

    def __init__(self, instance: "WebRenderInstance"):
        self._instance = instance
        self._next_image_key = 1
        self._next_font_key = 1
        self._next_font_instance_key = 1
        self._lock = threading.Lock()

    # key generators (render_api.rs generate_*_key)
    def generate_image_key(self) -> int:
        with self._lock:
            k = self._next_image_key
            self._next_image_key += 1
        return k

    def generate_font_key(self) -> int:
        with self._lock:
            k = self._next_font_key
            self._next_font_key += 1
        return k

    def generate_font_instance_key(self) -> int:
        with self._lock:
            k = self._next_font_instance_key
            self._next_font_instance_key += 1
        return k

    def send_transaction(self, txn: Transaction) -> None:
        if getattr(txn, "low_priority", False) and \
                self._instance.low_priority_tx is not None:
            # LowPrioritySceneBuilderThread (scene_builder_thread.rs:775):
            # background documents build on a separate, lower-priority
            # thread so they never stall interactive scenes
            with self._instance._low_pending_cv:
                self._instance._low_pending += 1
            self._instance.low_priority_tx.put(("transaction", txn))
        else:
            self._instance.scene_tx.put(("transaction", txn))

    def hit_test(self, point):
        self._instance.flush()
        return self._instance.backend.hit_test(point)

    def flush_scene_builder(self) -> None:
        self._instance.flush()

    def shut_down(self) -> None:
        self._instance.shut_down()


class WebRenderInstance:
    """create_webrender_instance (renderer/init.rs:292): spawns the scene
    builder and backend threads; `render()` runs on the caller's thread."""

    def __init__(self, device_size: Tuple[int, int], dpr: float = 1.0,
                 background_color: Optional[ColorF] = ColorF.WHITE,
                 notifier: Optional[RenderNotifier] = None,
                 support_low_priority_transactions: bool = False,
                 device="cuda"):
        self.backend = RenderBackend(device_size, dpr, background_color,
                                     device=device)
        self.notifier = notifier or RenderNotifier()
        self.scene_tx: "queue.Queue" = queue.Queue()
        self.backend_tx: "queue.Queue" = queue.Queue()
        self.result_rx: "queue.Queue" = queue.Queue()
        self.low_priority_tx: Optional["queue.Queue"] = None
        self._flush_done = threading.Event()
        self._scene_lock = threading.Lock()
        self.resource_lock = threading.Lock()
        self._low_pending = 0
        self._low_pending_cv = threading.Condition()
        self._shutdown = threading.Event()
        self._scene_thread = threading.Thread(
            target=self._scene_builder_loop, name="SceneBuilder", daemon=True)
        self._backend_thread = threading.Thread(
            target=self._backend_loop, name="WRRenderBackend", daemon=True)
        self._scene_thread.start()
        self._backend_thread.start()
        self._low_prio_thread = None
        if support_low_priority_transactions:
            self.low_priority_tx = queue.Queue()
            self._low_prio_thread = threading.Thread(
                target=self._low_priority_loop,
                name="LowPrioritySceneBuilder", daemon=True)
            self._low_prio_thread.start()

    def api(self) -> RenderApi:
        return RenderApi(self)

    # --- scene builder thread (scene_builder_thread.rs:308 run) ------------
    def _scene_builder_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                msg = self.scene_tx.get(timeout=0.1)
            except queue.Empty:
                continue
            if msg[0] == "transaction":
                self._build_and_forward(msg[1])
            elif msg[0] == "flush":
                self.backend_tx.put(("flush",))

    def _build_and_forward(self, txn: Transaction) -> None:
        """Scene ops + scene build run HERE, off the backend thread, so a
        slow build overlaps the previous frame's frame-build/render
        (scene_builder_thread.rs process_transaction :528).  The Scene is
        owned by this thread: the backend only consumes BuiltScenes."""
        self._rasterize_blobs(txn)
        built = None
        with self._scene_lock:
            if self.backend.apply_scene_ops(txn) and \
                    self.backend.scene.has_root_pipeline:
                from .scene.scene_builder import build_scene as _bs
                built = _bs(self.backend.scene,
                            self.backend.background_color)
        self.backend_tx.put(("built_transaction", txn, built))

    def _rasterize_blobs(self, txn: Transaction) -> None:
        """Async blob rasterization (api_resources.rs:240 + doc/blob.md):
        blob commands in the transaction rasterize ON THIS scene-builder
        thread, so the backend/render path only ever sees pixel results —
        the reference ships RasterizedBlobImages with the built scene the
        same way.  Rasterization is bounded to the template's visible
        rect when one is present."""
        handler = self.backend.resources.blob_handler
        if handler is None:
            return
        from .api.image import ImageData, ImageDescriptor, ImageFormat
        for up in txn.resource_updates:
            data = getattr(up, "data", None)
            if data is None or data.blob is None or data.pixels is not None:
                continue
            desc = up.descriptor
            try:
                px = handler.rasterize(desc, data.blob)
            except Exception:  # noqa: BLE001 — fall back to lazy raster
                continue
            up.data = ImageData(pixels=px, blob=data.blob)
            up.descriptor = ImageDescriptor(
                ImageFormat.RGBA8, desc.width, desc.height,
                flags=desc.flags)

    def _low_priority_loop(self) -> None:
        """scene_builder_thread.rs:775 LowPrioritySceneBuilderThread:
        drains the low-priority queue and forwards to the backend after the
        interactive queue is idle."""
        while not self._shutdown.is_set():
            try:
                msg = self.low_priority_tx.get(timeout=0.1)
            except queue.Empty:
                continue
            # yield to interactive work first
            while not self.scene_tx.empty() and not self._shutdown.is_set():
                self._sleep(0.001)
            if msg[0] == "transaction":
                self._build_and_forward(msg[1])
                with self._low_pending_cv:
                    self._low_pending -= 1
                    self._low_pending_cv.notify_all()

    @staticmethod
    def _sleep(t: float) -> None:
        import time
        time.sleep(t)

    # --- backend thread (render_backend.rs:785 run) -------------------------
    def _backend_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                msg = self.backend_tx.get(timeout=0.1)
            except queue.Empty:
                continue
            if msg[0] == "built_transaction":
                txn, built = msg[1], msg[2]
                # resources + frame state are guarded against the render
                # thread (renderer.render consumes pending uploads and
                # mutates the HBM atlases — resource_lock serializes the
                # two, matching the reference\'s update/render ordering)
                with self.resource_lock:
                    self.backend.apply_resource_updates(txn)
                    self.backend.apply_frame_ops(txn)
                    if built is not None:
                        self.backend.install_built_scene(built)
                    if txn.generate_frame_flag:
                        # render_backend.rs render_reasons accounting
                        self.backend.profiler.note_render_reasons(
                            int(txn.render_reasons))
                        frame = self.backend.build_frame()
                        self.result_rx.put(("publish_document", frame))
                        self.notifier.new_frame_ready()
            elif msg[0] == "flush":
                self._flush_done.set()

    # --- render thread (the caller) -----------------------------------------
    def render(self, timeout: float = 60.0) -> np.ndarray:
        """Consume the next published frame and execute it
        (renderer/mod.rs render :1241)."""
        kind, frame = self.result_rx.get(timeout=timeout)
        assert kind == "publish_document"
        with self.resource_lock:
            return self.backend.renderer.render(frame, self.backend.resources)

    def flush(self) -> None:
        """Barrier: wait until queued transactions are fully processed —
        including low-priority ones sent before the flush (their queue
        drains through the same accounting, so hit_test after flush never
        sees a stale scene)."""
        with self._low_pending_cv:
            self._low_pending_cv.wait_for(
                lambda: self._low_pending == 0, timeout=60.0)
        self._flush_done.clear()
        self.scene_tx.put(("flush",))
        self._flush_done.wait(timeout=60.0)

    def shut_down(self) -> None:
        self._shutdown.set()
        self._scene_thread.join(timeout=5.0)
        self._backend_thread.join(timeout=5.0)
        self.notifier.shut_down()


def create_webrender_instance(device_size: Tuple[int, int], dpr: float = 1.0,
                              background_color: Optional[ColorF] = ColorF.WHITE,
                              notifier: Optional[RenderNotifier] = None,
                              device="cuda"
                              ) -> Tuple[WebRenderInstance, RenderApi]:
    instance = WebRenderInstance(device_size, dpr, background_color, notifier,
                                 device=device)
    return instance, instance.api()
