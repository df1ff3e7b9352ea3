"""SaL's fixture files: a ``.npy`` of OCR words, boxes and det / rec
features an image under ``ocr_features/``, and one of its objects (labels,
region boxes and features) under ``obj_features/``, as the port's SaL
loader reads them. The mix's ``objects`` is [low, high] objects an image."""

import os

import numpy as np

from portbench import fixture

OBJECT_LABELS = ["người", "xe máy", "ô tô", "bảng hiệu", "cây", "đèn", "cửa", "bàn", "ghế",
                 "biển số", "chó", "mèo", "xe đạp", "nhà", "cột điện", "ô dù"]


def write(fx, rng) -> None:
    ocr, obj = (os.path.join(fx.root, k) for k in ("ocr_features", "obj_features"))
    os.makedirs(ocr, exist_ok=True)
    os.makedirs(obj, exist_ok=True)
    lo, hi = fx.mix["objects"]
    n_obj = rng.permutation(fixture.sizes(len(fx.image_ids), lo, hi, 2))
    half = int(fx.config["ocr_hidden"]) // 2
    for i, image_id in enumerate(fx.image_ids):
        k = len(fx.texts[i])
        fx.save(ocr, f"{int(image_id)}.npy", {
            "texts": fx.texts[i], "boxes": fx.boxes[i],
            "det_features": rng.standard_normal((k, half), dtype=np.float32),
            "rec_features": rng.standard_normal((k, half), dtype=np.float32)})
        m = int(n_obj[i])
        x0y0 = rng.uniform(0, 800, (m, 2))
        wh = rng.uniform(20, 200, (m, 2))
        fx.save(obj, f"{int(image_id)}.npy", {
            "object_list": list(rng.choice(OBJECT_LABELS, m)),
            "region_boxes": np.concatenate([x0y0, x0y0 + wh], 1),
            "height": 1024, "width": 1024,
            "region_features": rng.standard_normal(
                (m, int(fx.config["obj_hidden"])), dtype=np.float32)})
    fx.paths.update(ocr_features=ocr, obj_features=obj)
