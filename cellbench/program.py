"""The system under test, `caitlynrenderer_tpu_torch`, as the benchmark
drives it: its scene and camera types filled from the benchmark's own
arrays, its scene upload, its progressive loop and its resolve.  This is
the only module of the benchmark that imports the program.

The program logs its records as "<kind> <json>" lines: one
`graph_capture` for each CUDA graph it captures (its capture and
instantiate seconds and its node count), one `upload` for each scene
upload (the seconds of its steps), and others; `CaptureLog` keeps them by
kind for the per-layer readers.  `phase_groups` gives each device
operation of a trace the program's phase group, by the program's own
attribution.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from caitlynrenderer_tpu_torch import scene as pscene
from caitlynrenderer_tpu_torch.core.types import Camera, Lights, Materials, RenderOptions, SceneArrays
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.utils import metrics

from cellbench.scenes.builtin import CAMERA_FIELDS, IMAGES, LIGHT_FIELDS, MATERIAL_FIELDS

LOGGER = "caitlynrenderer_tpu_torch"


def scene_arrays(sc: dict) -> SceneArrays:
    """The program's SceneArrays holding copies of the arrays of `sc`;
    `textures` and `env_map` None where `sc` has none."""
    images = {k: None if sc.get(k) is None else sc[k].copy() for k in IMAGES}
    return SceneArrays(
        vertices=sc["vertices"].copy(), normals=sc["normals"].copy(),
        texcoords=sc["texcoords"].copy(), tri_v=sc["tri_v"].copy(),
        tri_vn=sc["tri_vn"].copy(), tri_vt=sc["tri_vt"].copy(),
        materials=Materials(*(sc["materials"][k].copy() for k in MATERIAL_FIELDS)),
        lights=Lights(*(sc["lights"][k].copy() for k in LIGHT_FIELDS)),
        **images,
    )


def camera(cam: dict) -> Camera:
    return Camera(*(np.array(cam[k], np.float32) for k in CAMERA_FIELDS))


class Renderer:
    """One configuration uploaded to `device`: `upload()` builds the
    accelerator and moves the scene there, then `launch`, `display` and
    `new_image` drive the progressive loop.  The program samples the
    scene's `env_map` on a miss where the scene carries one
    (`RenderOptions.use_env_map`), as the references refuse exactly such a
    scene."""

    def __init__(self, cfg: dict, sc: dict, cam: dict, device):
        self.device = torch.device(device)
        self.w, self.h = cfg["width"], cfg["height"]
        self.scene = scene_arrays(sc)
        self.camera = camera(cam)
        accel = cfg["accel"]
        self.accel = pscene.auto_accel(self.scene) if accel == "auto" else accel
        self.options = RenderOptions(width=self.w, height=self.h, max_depth=cfg["max_depth"],
                                     use_env_map=self.scene.env_map is not None,
                                     accel=self.accel,
                                     families=pscene.scene_families(self.scene))
        self.ds = None
        self.state = None

    def upload(self) -> None:
        self.ds = pscene.upload_scene(self.scene, self.accel, self.device,
                                      max_leaf=self.options.max_leaf)
        self.options = self.options._replace(max_stack=pscene.required_stack(self.ds))

    def new_image(self, seed: int) -> None:
        """Restart the accumulation under the base key of `seed`."""
        self.state = progressive.init_state(self.w, self.h, seed, self.device)

    def launch(self, spp: int) -> None:
        """Add `spp` samples in one launch from the host (a CUDA-graph
        replay on the card for spp > 1); returns without waiting."""
        self.state = progressive.render_steps(self.ds, self.camera, self.state, self.w, self.h,
                                              self.options, spp)

    @property
    def frame_count(self) -> int:
        return self.state.frame_count

    def display(self) -> np.ndarray:
        """The display image of the accumulation, copied to host memory:
        (H, W, 3) in [0, 1], row 0 at the top."""
        return progressive.resolve(self.state, self.w, self.h, self.options).cpu().numpy()

    def accum_rows(self, pixel_ids: np.ndarray) -> np.ndarray:
        """The accumulation's rows `pixel_ids`, (P, 3) float32 on the host."""
        ids = torch.as_tensor(pixel_ids, dtype=torch.int64, device=self.device)
        return self.state.accum.index_select(0, ids).cpu().numpy()

    def release(self) -> None:
        """Drop the scene, the state and every captured graph."""
        self.ds = self.state = None
        progressive.clear_graphs()


def phase_groups(events) -> list:
    """[(event, group or None)] for each device operation of a Chrome
    trace's events (its "traceEvents"): the program's phase of it
    (`utils/metrics.attribute` against the phase maps of the CUDA graphs
    cached now: take it before `Renderer.release`), as its phase group
    (`utils/metrics.phase_group`: raygen, query, hit, nee, bounce, shade,
    ...); None where no map or span places the operation."""
    return [(e, metrics.phase_group(phase))
            for e, phase in metrics.attribute(events, progressive.phase_maps())]


class CaptureLog(logging.Handler):
    """Keeps the program's log records while attached: `by_kind`, the
    records of each kind in the order logged; `records`, the
    `graph_capture` ones."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.by_kind: dict = {}

    @property
    def records(self) -> list:
        return self.by_kind.get("graph_capture", [])

    def emit(self, record: logging.LogRecord) -> None:
        kind, _, body = record.getMessage().partition(" ")
        try:
            rec = json.loads(body)
        except ValueError:  # a line that is no record
            return
        if isinstance(rec, dict):
            self.by_kind.setdefault(kind, []).append(rec)

    def __enter__(self):
        log = logging.getLogger(LOGGER)
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger(LOGGER)
        log.removeHandler(self)
        log.setLevel(self._level)
