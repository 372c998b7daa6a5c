from setuptools import find_packages, setup

setup(
    name="trajnetplusplusbaselines-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas/pjit) TrajNet++ trajectory-forecasting "
        "baselines: LSTM/SGAN/VAE with the full interaction-pooling registry, "
        "classical predictors (incl. a native C++ ORCA), and the TrajNet++ "
        "evaluator"
    ),
    packages=find_packages(
        include=["trajnetplusplusbaselines_tpu*", "trajnetplusplusbaselines_torch*"]
    ),
    package_data={
        "": ["../native/orca.cpp"],
        "trajnetplusplusbaselines_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
    ],
    extras_require={
        # the PyTorch / CUDA port (trajnetplusplusbaselines_torch); its kernels
        # build with nvcc at first use
        "torch": ["torch"],
        "plot": ["matplotlib", "pandas"],
        "test": ["pytest", "scipy"],
    },
)
