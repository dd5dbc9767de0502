"""Material dedup (SceneLayout.material_ids).

The reference's shader table points many records at shared root constants
(Renderer.cpp:201-250 defines ~11 materials reused across instances);
SceneBuilder mirrors that by deduping identical SHADING materials into a
unique table plus a per-geometry slot map, so the material select chains
scale with UNIQUE materials, not instances (the 16-instance analytic grid
has 3 + plane).
"""

import numpy as np

from gpuraytracer.models.scenes import get_config
from gpuraytracer.render import trace


def _grid_scene():
    return get_config("analytic_grid_720p").build(16 / 9, 0.7)


def test_grid_material_table_dedups():
    scene = _grid_scene()
    lay = scene.layout
    # 16 instances + plane share CHROME/RED/YELLOW + plane = 4 unique rows.
    assert scene.arrays.materials.albedo.shape[0] == 4
    assert lay.material_ids is not None
    assert len(lay.material_ids) == lay.num_geometries == 17
    assert max(lay.material_ids) == 3
    # step_scale is a per-GEOMETRY march parameter — never deduped.
    assert scene.arrays.materials.step_scale.shape[0] == 17


def test_gather_materials_mapping_matches_expansion():
    scene = _grid_scene()
    lay = scene.layout
    mats = scene.arrays.materials
    gid = np.arange(-1, lay.num_geometries, dtype=np.int32)
    got = trace._gather_materials(mats, gid, lay.material_ids)
    ids = np.asarray(lay.material_ids)
    # Expansion reference: direct row fetch through the slot map (miss
    # gid -1 clamps to slot 0, callers mask it).
    slots = np.concatenate([[0], ids])
    for field, table in zip(
        got,
        (mats.albedo, mats.reflectance_coefficient, mats.diffuse_coefficient,
         mats.specular_coefficient, mats.specular_power),
    ):
        np.testing.assert_array_equal(
            np.asarray(field), np.asarray(table)[slots]
        )
