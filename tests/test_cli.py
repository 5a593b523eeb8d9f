"""CLI end-to-end tests (in-process, CPU backend from conftest)."""

import pytest

from huffman_jax.cli import main


@pytest.fixture
def datafile(tmp_path):
    path = tmp_path / "data.bin"
    main(["generate", "--size", "30000", "--redundancy", "0.5",
          "--seed", "3", "-o", str(path)])
    assert path.stat().st_size == 30000
    return path


@pytest.mark.parametrize("fmt", ["ils", "htc1"])
def test_cli_encode_decode(tmp_path, datafile, fmt, capsys):
    enc = tmp_path / f"data.{fmt}"
    out = tmp_path / "out.bin"
    main(["encode", str(datafile), "--format", fmt, "-o", str(enc),
          "--k", "8"] if fmt == "ils" else
         ["encode", str(datafile), "--format", fmt, "-o", str(enc)])
    main(["decode", str(enc), "-o", str(out)])  # auto-detect by magic
    assert out.read_bytes() == datafile.read_bytes()


@pytest.mark.parametrize("fmt", ["yamamoto", "seq"])
def test_cli_reference_formats(tmp_path, datafile, fmt):
    enc = tmp_path / f"data.{fmt}"
    out = tmp_path / "out.bin"
    main(["encode", str(datafile), "--format", fmt, "-o", str(enc)])
    main(["decode", str(enc), "--format", fmt, "-o", str(out)])
    assert out.read_bytes() == datafile.read_bytes()


def test_cli_roundtrip(datafile, capsys):
    main(["roundtrip", str(datafile), "--format", "ils", "--k", "8"])
    assert "PASS" in capsys.readouterr().out


def test_cli_decode_garbage(tmp_path, capsys):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"ZZZZ garbage")
    with pytest.raises(SystemExit):
        main(["decode", str(bad), "-o", str(tmp_path / "out.bin")])


def test_distributed_noop_single_host():
    from huffman_jax.utils.distributed import init_multihost, is_multihost

    init_multihost()  # must be a harmless no-op without a coordinator
    assert not is_multihost()
