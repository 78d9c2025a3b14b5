"""The plain references: numpy and torch only, nothing of the program.

A configuration names its reference by the key "reference" of its file,
the module cellbench/reference/<name>.py (`manifest.reference`); a file
without the key takes `tracer`, the Lambert path tracer, which refuses
every other material.  A reference module gives:

    load_scene(sc, device, dtype)   its tables of a scene dict
                                    (cellbench.scenes.builtin's layout) in
                                    `dtype`: the configuration's precision,
                                    or a lower one for the control.  The
                                    result has `.geo`, an accel.Geometry,
                                    which the roofline readers read.
    refuse_camera(cam)              raises ValueError for a camera it does
                                    not trace; `check.Reference` calls it
                                    with `load_scene`, before any ray
    camera_rays(cam, width, height, pixel_ids, raygen, dtype)
                                    (o, d) of pixels `pixel_ids` from their
                                    four raygen uniforms `raygen` ((N, 4):
                                    the tent jitter pair, the lens pair)
    trace(scene, o, d, uni, max_depth, record=None)
                                    (N, 3) float32 radiance of the paths
                                    from (o, d) under the uniforms `uni`
                                    (sampler.uniforms' rows); `record`, if a
                                    list, receives each query's rays as
                                    ("closest", o, d, active) and
                                    ("anyhit", o, d, t_max, active)
    accumulate(scene, cam, width, height, max_depth, key, samples, pixel_ids)
                                    (P, 3) float32: samples 0 .. samples - 1
                                    of pixels `pixel_ids` under base key
                                    `key`, added in the program's order
    display(acc, samples)           the display values of an accumulation

`sampler` (the program's uniforms) and `accel` (the queries) serve every
reference.  A reference raises ValueError for what it does not trace,
so that no configuration is judged against one that drops part of its
light or its lens: `tracer`, `disney` and `specular` refuse an
environment map, a texture atlas or textured material (`load_scene`),
and a camera whose aperture is above 0 (`refuse_camera`, which their
`camera_rays` calls too).
"""
