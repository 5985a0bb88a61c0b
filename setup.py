from setuptools import find_packages, setup

setup(
    name="pfb_tpu",
    version="0.1.0",
    description=("Radio-interferometric imaging: the "
                 "pre-conditioned forward-backward deconvolution stack "
                 "in JAX/XLA"),
    packages=find_packages(include=["pfb_tpu", "pfb_tpu.*"]),
    package_data={"pfb_tpu.parser": ["*.yaml", "*.yml"],
                  "pfb_tpu.native": ["*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "sympy", "click",
                      "pyyaml"],
    entry_points={
        "console_scripts": ["pfb-tpu = pfb_tpu.workers.main:cli"],
    },
)
