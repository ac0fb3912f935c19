"""The port's copy of the downloader, held to the JAX package's downloader
tests (``tests/test_download.py``): checksum parsing and verification,
resumable downloads and the fetch's retry policy.  ``_fetch`` (or its
opener) is replaced in every case, so nothing touches the network."""

from pathlib import Path

import pytest

from jax_llama_tpu_torch.download import (
    N_SHARDS,
    md5_file,
    parse_checklist,
    verify_checklist,
)


def test_parse_checklist_md5sum_format():
    text = "0123abc  consolidated.00.pth\ndeadbeef *params.json\n\n"
    assert parse_checklist(text) == [
        ("0123abc", "consolidated.00.pth"),
        ("deadbeef", "params.json"),
    ]


def test_verify_checklist_roundtrip(tmp_path: Path):
    f = tmp_path / "params.json"
    f.write_bytes(b'{"dim": 4096}')
    (tmp_path / "checklist.chk").write_text(f"{md5_file(f)}  params.json\n")
    assert verify_checklist(tmp_path)
    f.write_bytes(b"corrupted")
    assert not verify_checklist(tmp_path)


def test_verify_checklist_missing_file(tmp_path: Path):
    (tmp_path / "checklist.chk").write_text("00ff  missing.pth\n")
    assert not verify_checklist(tmp_path)
    assert not verify_checklist(tmp_path / "nonexistent")


def test_shard_counts_cover_published_sizes():
    # The shard count equals the model-parallel degree of the published
    # checkpoints.
    assert N_SHARDS["7B"] == 1 and N_SHARDS["13B"] == 2
    assert N_SHARDS["65B"] == 8 and N_SHARDS["70B"] == 8


def test_download_resumes_verified_shards(tmp_path: Path, monkeypatch):
    """Interrupted model download re-fetches only missing/corrupt shards."""
    import jax_llama_tpu_torch.download as dl

    d = tmp_path / "13B"
    d.mkdir()
    good = d / "consolidated.00.pth"
    good.write_bytes(b"shard zero")
    params = d / "params.json"
    params.write_bytes(b"{}")
    # checklist covers both shards + params; shard 1 is missing (interrupt)
    (d / "checklist.chk").write_text(
        f"{md5_file(good)}  consolidated.00.pth\n"
        f"{md5_file(params)}  params.json\n"
        "0123456789abcdef0123456789abcdef  consolidated.01.pth\n"
    )
    (tmp_path / "tokenizer.model").write_bytes(b"tok")
    (tmp_path / "tokenizer_checklist.chk").write_text(
        f"{md5_file(tmp_path / 'tokenizer.model')}  tokenizer.model\n"
    )

    fetched = []

    def fake_fetch(url, dest):
        fetched.append(dest.name)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(b"shard one")

    monkeypatch.setattr(dl, "_fetch", fake_fetch)
    # final verify fails (fake shard 1 has wrong digest) -> SystemExit; the
    # point of the test is which files were fetched before that.
    try:
        dl.download("https://host/*?sig", ["13B"], tmp_path)
    except SystemExit:
        pass
    assert fetched == ["consolidated.01.pth"]


class _FakeResponse:
    """Minimal context-managed urlopen response."""

    def __init__(self, payload: bytes):
        import io

        self._buf = io.BytesIO(payload)

    def __enter__(self):
        return self._buf

    def __exit__(self, *exc):
        return False


def test_fetch_retries_transient_then_succeeds(tmp_path: Path):
    """A flaky opener (URLError, then HTTP 503) is retried with
    exponential backoff + jitter and a socket timeout on every attempt;
    the third attempt lands atomically (no .part left behind)."""
    import urllib.error

    import jax_llama_tpu_torch.download as dl

    calls, sleeps = [], []

    def opener(url, timeout):
        calls.append(timeout)
        if len(calls) == 1:
            raise urllib.error.URLError("connection reset")
        if len(calls) == 2:
            raise urllib.error.HTTPError(url, 503, "unavailable", None, None)
        return _FakeResponse(b"payload")

    dest = tmp_path / "f.bin"
    dl._fetch(
        "https://host/f.bin?sig", dest,
        opener=opener, sleep=sleeps.append, jitter=lambda: 0.5,
    )
    assert dest.read_bytes() == b"payload"
    assert not (tmp_path / "f.bin.part").exists()
    assert calls == [dl.FETCH_TIMEOUT_S] * 3   # timeout on every attempt
    # base * 2^attempt * (0.5 + jitter): bounded exponential backoff
    assert sleeps == [dl.FETCH_BACKOFF_BASE_S * 1.0,
                      dl.FETCH_BACKOFF_BASE_S * 2.0]


def test_fetch_4xx_fails_immediately(tmp_path: Path):
    """Client errors (expired presigned URL) are not transient: no
    retry, no sleep."""
    import urllib.error

    import jax_llama_tpu_torch.download as dl

    calls, sleeps = [], []

    def opener(url, timeout):
        calls.append(url)
        raise urllib.error.HTTPError(url, 403, "forbidden", None, None)

    with pytest.raises(urllib.error.HTTPError):
        dl._fetch(
            "https://host/x?sig", tmp_path / "x",
            opener=opener, sleep=sleeps.append,
        )
    assert len(calls) == 1 and sleeps == []


def test_fetch_retry_budget_is_bounded(tmp_path: Path):
    """A persistently failing fetch raises after 1 + retries attempts."""
    import urllib.error

    import jax_llama_tpu_torch.download as dl

    calls, sleeps = [], []

    def opener(url, timeout):
        calls.append(url)
        raise urllib.error.URLError("no route to host")

    with pytest.raises(urllib.error.URLError):
        dl._fetch(
            "https://host/x?sig", tmp_path / "x",
            opener=opener, retries=2, sleep=sleeps.append,
            jitter=lambda: 0.0,
        )
    assert len(calls) == 3
    assert sleeps == [0.5, 1.0]   # base * 2^attempt * 0.5 (no jitter)


def test_download_module_matches_jax():
    """The copy keeps the JAX package's shard table and retry policy."""
    import jax_llama_tpu.download as jdl
    import jax_llama_tpu_torch.download as dl

    assert dl.N_SHARDS == jdl.N_SHARDS
    assert (dl.FETCH_TIMEOUT_S, dl.FETCH_RETRIES, dl.FETCH_BACKOFF_BASE_S,
            dl._NONRETRYABLE_ERRNO) == (
        jdl.FETCH_TIMEOUT_S, jdl.FETCH_RETRIES, jdl.FETCH_BACKOFF_BASE_S,
        jdl._NONRETRYABLE_ERRNO)


def test_fetch_disk_errors_are_not_retried(tmp_path: Path):
    """A local-filesystem error (a full disk) is raised at once."""
    import errno

    import jax_llama_tpu_torch.download as dl

    calls, sleeps = [], []

    def opener(url, timeout):
        calls.append(url)
        raise OSError(errno.ENOSPC, "No space left on device")

    with pytest.raises(OSError):
        dl._fetch("https://host/x?sig", tmp_path / "x", opener=opener,
                  sleep=sleeps.append)
    assert len(calls) == 1 and sleeps == []
