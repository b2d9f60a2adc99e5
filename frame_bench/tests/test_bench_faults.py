"""The check refuses a timed path broken underneath the harness: the
rest of a run, driven on the CPU at a tiny size with the card's look
skipped, comes out not correct for each fault a cell can have. A frame
path on one card has no exchange between chips to leave out."""

import pytest

import zeldaengine_tpu_torch.engine as engine_mod
import zeldaengine_tpu_torch.passes.frame as frame_mod
from frame_bench.harness.cell import Run


def stale(fn):
    """A step that returns its state unchanged: every call hands back the
    first frame's outputs."""
    first = []

    def broken(*args):
        if not first:
            first.append(fn(*args))
        return first[0]
    return broken


def half(fn):
    """Half of the frame left out: the lower half of every buffer as if
    nothing covered it."""
    def broken(*args):
        color, aux = fn(*args)
        h = color.shape[0] // 2
        color = color.clone()
        color[h:] = 0.0
        aux = dict(aux)
        for key, empty in (("gbuffer_depth", 1.0), ("tri_id", -1)):
            aux[key] = aux[key].clone()
            aux[key][h:] = empty
        return color, aux
    return broken


def altered(fn):
    """An answer altered where it is produced: one raster tile's block
    (32 x 128 pixels, or the whole of a smaller frame) of the lit image
    inverted."""
    def broken(*args):
        color, aux = fn(*args)
        color = color.clone()
        block = color[:32, :128]
        block.copy_(1.0 - block)
        return color, aux
    return broken


@pytest.mark.parametrize("fault", [stale, half, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["tiny.orbit", "tinymesh.orbit"])
def test_a_broken_frame_is_not_correct(tiny_bench, few_warm_frames,
                                       monkeypatch, fault, cell):
    bench, folder = tiny_bench
    module = engine_mod if cell == "tiny.orbit" else frame_mod
    monkeypatch.setattr(module, "render_frame", fault(module.render_frame))
    out = Run(bench, cell, 1234567, 1.5, 0, device="cpu",
              bench_dir=folder).execute()
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checked"].values())


def test_a_presented_image_of_no_frame_is_not_correct(tiny_bench,
                                                      few_warm_frames,
                                                      monkeypatch):
    """The present path broken: every tick presents a black image, which
    no rendered frame quantises to; the check counts it unmatched."""
    bench, folder = tiny_bench
    tick = engine_mod.Engine.tick

    def black(self):
        return tick(self) * 0
    monkeypatch.setattr(engine_mod.Engine, "tick", black)
    out = Run(bench, "tiny.orbit", 99, 1.5, 0, device="cpu",
              bench_dir=folder).execute()
    assert out["correct"] is False
    assert out["checked"]["unmatched"]["value"] >= 1


def test_a_cap_that_drops_triangles_is_not_correct(tiny_bench,
                                                   few_warm_frames):
    """A compaction cap below the frame's live triangles drops some; the
    reference drops none, and the check counts the drops."""
    import json
    bench, folder = tiny_bench
    path = folder / "configs" / "mesh_tiny.json"
    cfg = json.loads(path.read_text())
    cfg["settings"]["compact_tris"] = 16
    path.write_text(json.dumps(cfg))
    out = Run(bench, "tinymesh.orbit", 99, 1.5, 0, device="cpu",
              bench_dir=folder).execute()
    assert out["correct"] is False
    assert out["checked"]["dropped"]["value"] > 0
