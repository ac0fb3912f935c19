"""Meta checkpoint downloader with checksum verification (a copy of
``jax_llama_tpu/download.py``; the port imports nothing of the JAX package).

The reference's ``download.sh`` (a presigned-URL wget loop + ``md5sum -c``
verification) as a Python CLI: portable, resumable (it skips files that
already verify), and unit-testable:

    python -m jax_llama_tpu_torch.download \
        --presigned-url 'https://...*...' \
        --model-sizes 7B,13B \
        --target-dir /data/llama

The presigned URL contains a ``*`` placeholder that is substituted with
each file's relative path (the contract of the email Meta sends).  After
downloading, run the converter:

    python -m jax_llama_tpu_torch.convert --ckpt-dir /data/llama/7B ...
"""

from __future__ import annotations

import argparse
import errno
import hashlib
import random
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

# consolidated.*.pth shard count per model size (the reference's
# download.sh:9-13 covers LLaMA-1; LLaMA-2/3 use the same layout).
N_SHARDS: Dict[str, int] = {
    "7B": 1, "13B": 2, "30B": 4, "33B": 4, "65B": 8,
    "70B": 8, "8B": 1, "8B-Instruct": 1, "70B-Instruct": 8,
}


def md5_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def parse_checklist(text: str) -> List[Tuple[str, str]]:
    """Parse ``md5sum``-format checklist lines into (hexdigest, filename)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        digest, _, name = line.partition(" ")
        out.append((digest.strip(), name.strip().lstrip("*")))
    return out


def verify_checklist(directory: Path, checklist_name: str = "checklist.chk") -> bool:
    """Equivalent of ``(cd dir && md5sum -c checklist.chk)``."""
    checklist = directory / checklist_name
    if not checklist.exists():
        return False
    ok = True
    for digest, name in parse_checklist(checklist.read_text()):
        target = directory / name
        if not target.exists() or md5_file(target) != digest:
            print(f"  FAILED {target}")
            ok = False
    return ok


# Transient-failure policy for _fetch: a hard socket timeout (a stalled
# CDN connection must not hang a 130 GB download forever) plus bounded
# exponential backoff with jitter on transient errors — URLError
# (connection reset / DNS / timeout) and HTTP 5xx.  4xx (e.g. an expired
# presigned URL) fails immediately: retrying cannot fix it.
FETCH_TIMEOUT_S = 60.0
FETCH_RETRIES = 4          # total attempts = 1 + FETCH_RETRIES
FETCH_BACKOFF_BASE_S = 1.0
# Local-filesystem errnos retrying a download can never fix (the OSError
# branch below otherwise also wraps the .part write/rename): surface
# them immediately instead of re-pulling a multi-GB shard with backoff.
_NONRETRYABLE_ERRNO = frozenset({
    errno.ENOSPC, errno.EACCES, errno.EROFS, errno.EDQUOT, errno.EISDIR,
})


def _fetch(
    url: str,
    dest: Path,
    *,
    timeout: float = FETCH_TIMEOUT_S,
    retries: int = FETCH_RETRIES,
    opener: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    jitter: Optional[Callable[[], float]] = None,
) -> None:
    """Download ``url`` to ``dest`` atomically (.part then rename), with
    a socket timeout and bounded retry.  ``opener``/``sleep``/``jitter``
    are injectable for unit tests (default: ``urllib.request.urlopen``,
    ``time.sleep``, ``random.random``)."""
    import urllib.error
    import urllib.request

    opener = opener or urllib.request.urlopen
    jitter = jitter or random.random
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    print(f"  {dest.name} <- {url.split('?')[0]}")
    for attempt in range(retries + 1):
        try:
            with opener(url, timeout=timeout) as r, open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            tmp.rename(dest)
            return
        except urllib.error.HTTPError as e:
            # HTTPError subclasses URLError — catch it first.  Only
            # server-side (5xx) failures are transient.
            if e.code < 500 or attempt == retries:
                raise
            err = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # URLError/TimeoutError carry no filesystem errno, so this
            # only fires for genuine disk-side failures.
            if getattr(e, "errno", None) in _NONRETRYABLE_ERRNO:
                raise
            if attempt == retries:
                raise
            err = e
        # Full-jitter exponential backoff: base * 2^attempt * U(0.5, 1.5),
        # capped implicitly by the bounded retry count.
        delay = FETCH_BACKOFF_BASE_S * (2 ** attempt) * (0.5 + jitter())
        print(f"  retrying in {delay:.1f}s ({err})")
        sleep(delay)


def download(presigned_url: str, model_sizes: List[str], target: Path) -> None:
    sub = lambda rel: presigned_url.replace("*", rel)

    if verify_checklist(target, "tokenizer_checklist.chk"):
        print("Tokenizer already downloaded and verified, skipping")
    else:
        print("Downloading tokenizer")
        for name in ("tokenizer.model", "tokenizer_checklist.chk"):
            _fetch(sub(name), target / name)
        if not verify_checklist(target, "tokenizer_checklist.chk"):
            raise SystemExit("tokenizer checksum verification failed")

    for size in model_sizes:
        if size not in N_SHARDS:
            raise SystemExit(f"unknown model size {size!r}; have {sorted(N_SHARDS)}")
        d = target / size
        if verify_checklist(d):
            print(f"{size}: already downloaded and verified, skipping")
            continue
        print(f"Downloading {size}")
        # Checklist first, so per-shard resume can verify against it: an
        # interrupted 8-shard (~130GB) download then re-fetches only the
        # shards that are missing or fail their checksum.
        for name in ("checklist.chk", "params.json"):
            if not (d / name).exists():
                _fetch(sub(f"{size}/{name}"), d / name)
        digests = {
            name: digest
            for digest, name in parse_checklist((d / "checklist.chk").read_text())
        }
        for s in range(N_SHARDS[size]):
            name = f"consolidated.{s:02d}.pth"
            dest = d / name
            if dest.exists() and digests.get(name) == md5_file(dest):
                print(f"  {name}: verified, skipping")
                continue
            _fetch(sub(f"{size}/{name}"), dest)
        print("Checking checksums")
        if not verify_checklist(d):
            raise SystemExit(f"{size}: checksum verification failed")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--presigned-url", required=True,
                    help="URL with a '*' placeholder (from Meta's email)")
    ap.add_argument("--model-sizes", default="7B",
                    help="comma-separated, e.g. 7B,13B,70B")
    ap.add_argument("--target-dir", required=True)
    args = ap.parse_args()
    download(
        args.presigned_url,
        [s.strip() for s in args.model_sizes.split(",") if s.strip()],
        Path(args.target_dir),
    )


if __name__ == "__main__":
    main()
