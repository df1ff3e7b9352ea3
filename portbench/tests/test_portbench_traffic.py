"""The one traffic generator, with the layouts and the request generator
it finds by name, repeats exactly by seed, and gives every seed the same
sizes in another order."""

import os

import numpy as np

from portbench import fixture, manifest

LATR = {"max_ocr_element": 50, "vit_image_size": 32}
SAL = {"max_ocr_element": 32, "ocr_hidden": 16, "obj_hidden": 8}


def _mix(name):
    mix = manifest.traffic(name)
    mix.update(images=12, rows=40, requests=60, answer_words=[1, 8], answer_from_ocr=0.5)
    return mix


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            rec = np.load(os.path.join(d, n), allow_pickle=True).tolist()
            out[os.path.relpath(os.path.join(d, n), root)] = {
                k: (np.asarray(v).tolist() if not isinstance(v, (int, float)) else v)
                for k, v in rec.items()}
    return out


def test_fixture_repeats_by_seed(tmp_path):
    seed = 2**31 + 99
    for layout, cfg, mix in (("latr", LATR, "serve-flood"), ("sal", SAL, "train")):
        a = fixture.Fixture(str(tmp_path / f"a{layout}"), seed, _mix(mix), cfg, layout)
        b = fixture.Fixture(str(tmp_path / f"b{layout}"), seed, _mix(mix), cfg, layout)
        c = fixture.Fixture(str(tmp_path / f"c{layout}"), seed + 1, _mix(mix), cfg, layout)
        assert _files(a.root) == _files(b.root)
        assert _files(a.root) != _files(c.root)
        assert a.rows() == b.rows() and a.requests() == b.requests()
        assert a.rows() != c.rows() and a.requests() != c.requests()


def test_every_seed_gets_the_same_sizes(tmp_path):
    sizes = []
    for seed in (1, 2**33 + 5):
        f = fixture.Fixture(str(tmp_path / str(seed)), seed, _mix("train"), SAL, "sal")
        rows = f.rows()
        sizes.append((sorted(len(t) for t in f.texts),
                      sorted(len(r["question"].split()) for r in rows),
                      sorted(len(r["answer"].split()) for r in rows if r["answer"])))
        assert len({(r["image_id"], r["question"]) for r in rows}) == len(rows)
    assert sizes[0][:2] == sizes[1][:2]
