"""LaTr's fixture files: a ``.npy`` of OCR words and boxes an image under
``ocr/``, and one of its pixels (``{"image": (1, 3, H, W)}``) under
``img/``, as the port's LaTr loader reads them."""

import os

import numpy as np


def write(fx, rng) -> None:
    ocr, img = (os.path.join(fx.root, k) for k in ("ocr", "img"))
    os.makedirs(ocr, exist_ok=True)
    os.makedirs(img, exist_ok=True)
    hw = int(fx.config["vit_image_size"])
    for i, image_id in enumerate(fx.image_ids):
        fx.save(ocr, f"{int(image_id)}.npy", {"texts": fx.texts[i], "boxes": fx.boxes[i]})
        pixels = rng.standard_normal((1, 3, hw, hw), dtype=np.float32)
        fx.save(img, f"{image_id}.npy", {"image": pixels})
    fx.paths.update(ocr=ocr, img=img)
