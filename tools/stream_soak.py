"""Streaming soak: long clip through the CLI's --window path, bounded
memory, byte-identity vs whole-clip processing.

Generates a synthetic y4m, runs the CLI twice (whole-clip and windowed),
verifies byte-identical output, and reports peak RSS of the windowed run
(the number quoted in README "Tests").

    python tools/stream_soak.py [frames] [window] [bob]

Passing ``bob`` as the third argument soaks the CLI's --bob double-rate
path instead (round 3: the fused SeparateFields+filter single-jit bob;
windowed output must stay byte-identical to whole-clip).
"""
import filecmp
import os
import resource
import subprocess
import sys
import tempfile

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 480
    window = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    use_bob = len(sys.argv) > 3 and sys.argv[3] == "bob"

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from sangnom_jax.core.clip import Clip
    from sangnom_jax.io import write_y4m

    rng = np.random.default_rng(42)
    w, h = 640, 480
    tmp = tempfile.mkdtemp(prefix="sangnom_soak_")
    src = os.path.join(tmp, "in.y4m")
    planes = [
        rng.integers(0, 256, (frames, h, w)).astype(np.uint8),
        rng.integers(0, 256, (frames, h // 2, w // 2)).astype(np.uint8),
        rng.integers(0, 256, (frames, h // 2, w // 2)).astype(np.uint8),
    ]
    write_y4m(src, Clip.from_numpy(planes, "YUV420P8"))
    del planes

    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    outs = {}
    for name, extra in (("whole", []), ("windowed", ["--window",
                                                     str(window)])):
        dst = os.path.join(tmp, f"{name}.y4m")
        outs[name] = dst
        mode = ["--bob"] if use_bob else ["--order", "1"]
        cmd = [sys.executable, "-m", "sangnom_jax", src, dst,
               "--aa", "48"] + mode + extra
        # run under a child so RSS is the CLI's, not ours
        r = subprocess.run(
            [sys.executable, "-c",
             "import resource, subprocess, sys;"
             "rc = subprocess.call(sys.argv[1:]);"
             "ru = resource.getrusage(resource.RUSAGE_CHILDREN);"
             "print(f'PEAK_RSS_MB={ru.ru_maxrss/1024:.0f}');"
             "sys.exit(rc)"] + cmd,
            capture_output=True, text=True, env=env, timeout=7200,
        )
        if r.returncode != 0:
            print(r.stderr[-2000:])
            return 1
        rss = [ln for ln in r.stdout.splitlines() if "PEAK_RSS" in ln]
        print(f"{name}: {rss[0] if rss else '?'}  "
              f"({r.stderr.strip().splitlines()[-1]})")
    # chunked compare: the soak exists to prove bounded memory, so don't
    # hold both multi-GB outputs in RAM to check them
    same = filecmp.cmp(outs["whole"], outs["windowed"], shallow=False)
    size = os.path.getsize(outs["whole"])
    print(f"byte-identical: {same}  ({size/1e6:.0f} MB output)")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
