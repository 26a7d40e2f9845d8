from setuptools import find_packages, setup

setup(
    name="edl_tpu",
    version="0.1.0",
    description=("TPU-native elastic deep learning: elastic collective "
                 "training and a distillation service plane on JAX/XLA"),
    # edl_tpu_torch: the PyTorch/CUDA port (needs the "torch" extra)
    packages=find_packages(include=["edl_tpu", "edl_tpu.*",
                                    "edl_tpu_torch", "edl_tpu_torch.*"]),
    package_data={"edl_tpu_torch": ["ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "msgpack", "psutil",
    ],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            # reference parity: `edlrun` (setup.py.in:85)
            "edl-tpu-run=edl_tpu.controller.launch:main",
            "edl-tpu-store=edl_tpu.coordination.server:main",
            "edl-tpu-store-standby=edl_tpu.coordination.standby:main",
            "edl-tpu-teacher=edl_tpu.distill.teacher_server:main",
            "edl-tpu-torch-teacher=edl_tpu_torch.distill.teacher_server:main",
            "edl-tpu-discovery=edl_tpu.distill.discovery_server:main",
            "edl-tpu-register=edl_tpu.distill.registry:main",
            "edl-tpu-measure-distill=edl_tpu.tools.measure_distill:main",
            "edl-tpu-measure-resize=edl_tpu.tools.measure_resize:main",
            "edl-tpu-job-stats=edl_tpu.tools.job_stats:main",
            "edl-tpu-resize-driver=edl_tpu.tools.resize_driver:main",
            "edl-tpu-liveft=edl_tpu.liveft.launch:main",
            "edl-tpu-store-witness=edl_tpu.coordination.standby:witness_main",
            "edl-tpu-fake-gcs=edl_tpu.tools.fake_gcs:main",
            "edl-tpu-k8s-operator=edl_tpu.tools.k8s_operator:main",
        ],
    },
)
