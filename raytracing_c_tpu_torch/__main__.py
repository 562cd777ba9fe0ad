"""python -m raytracing_c_tpu_torch [flags] model.(obj|glb|gltf): see cli.py."""

from raytracing_c_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
