"""Host-side input pipeline: ``edl_tpu/data/input_pipeline.py``'s
deterministic synthetic stream and image-folder listing, in numpy.

``synthetic_pipeline`` yields the JAX package's batches byte for byte
(the same ``RandomState`` streams). ``image_folder_pipeline`` decodes
JPEGs with TensorFlow's ``tf.data`` in the JAX package; the card's
machine has no TensorFlow, so the port raises there: a decoder for real
images comes with the native loader (ROADMAP A18).
"""

import os

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255


def list_image_files(root):
    """(path, label) pairs from a class-per-subdirectory tree, and the
    sorted class names."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    out = []
    for label, cls in enumerate(classes):
        d = os.path.join(root, cls)
        for name in sorted(os.listdir(d)):
            if name.lower().endswith((".jpg", ".jpeg", ".png")):
                out.append((os.path.join(d, name), label))
    return out, classes


def image_folder_pipeline(root, batch_size, image_size=224, train=True,
                          epoch_seed=0, shard_index=0, shard_count=1,
                          prefetch=4):
    """Not ported: the JAX package decodes with TensorFlow, which the
    port does not depend on. Raises ``NotImplementedError``."""
    raise NotImplementedError(
        "image_folder_pipeline is not ported to edl_tpu_torch: the JAX "
        "package decodes JPEGs with TensorFlow; real-image input comes "
        "with the native loader (ROADMAP A18)")


def synthetic_pipeline(batch_size, image_size=224, num_classes=1000,
                       steps=None, seed=0):
    """Deterministic synthetic image stream (benchmark / smoke mode):
    ``{"image": [b, h, w, 3] f32 NHWC, "label": [b] int32}`` numpy
    batches, batch ``step`` from ``RandomState(seed * 100003 + step)``."""
    step = 0
    while steps is None or step < steps:
        rng = np.random.RandomState(seed * 100003 + step)
        yield {
            "image": rng.randn(batch_size, image_size, image_size, 3)
                        .astype(np.float32),
            "label": rng.randint(0, num_classes,
                                 (batch_size,)).astype(np.int32),
        }
        step += 1
