"""Checkpoint / resume of the port (abc_tpu_torch.utils.checkpoint) against
abc_tpu.utils.checkpoint, on the CPU.

Every checkpoint case of tests/test_cli_checkpoint.py, the two of
tests/test_advisor_r4_regressions.py and test_hybrid_checkpoint_roundtrip of
tests/test_ckks.py runs in both directions: a file written by one package is
read by the other. The reader holds the writer's keys word for word
(np.array_equal), decrypts what the reference test decrypts, and a file read
by both packages gives the same next encryption and the same product words
(the reference's np64 engine, the port's CPU path; no tolerance on words).

Then the port's two deliberate differences (ROADMAP Queue 3): a file saved
without the secret carries no master seed and a context loaded from it
holds no secret; a loaded context keeps the file's public seed, so that
seeded files can be saved again.
"""

import json

import numpy as np
import pytest
import torch

import abc_tpu
import abc_tpu.utils.checkpoint as ref_ckpt
import abc_tpu_torch
import abc_tpu_torch.utils.checkpoint as port_ckpt
from abc_tpu.crypto.bfv import BfvContext as RefBfv
from abc_tpu.crypto.ckks import CkksContext as RefCkks
from abc_tpu.crypto.ckks import CkksParams as RefCkksParams
from abc_tpu.crypto.params import BfvParams as RefBfvParams
from abc_tpu_torch.crypto.bfv import BfvContext
from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
from abc_tpu_torch.crypto.params import BfvParams
from abc_tpu_torch.crypto.rlwe import RlweKeys
from abc_tpu_torch.ops.modarith import to_host
from abc_tpu_torch.utils.errors import RuntimeExecutionError

DIRECTIONS = [("ref", "port"), ("port", "ref")]
IDS = ["ref-writes-port-reads", "port-writes-ref-reads"]


def bfv(pkg, n, seed, engine="np64", ks_digits=1):
    if pkg == "ref":
        return RefBfv(RefBfvParams.create(n, engine=engine, seed=seed,
                                          ks_digits=ks_digits))
    return BfvContext(BfvParams.create(n, seed=seed, ks_digits=ks_digits),
                      "cpu")


def ckks(pkg, n, levels, seed, engine="np64", ks_digits=1):
    if pkg == "ref":
        return RefCkks(RefCkksParams.create(n, levels=levels, engine=engine,
                                            seed=seed, ks_digits=ks_digits))
    return CkksContext(CkksParams.create(n, levels=levels, seed=seed,
                                         ks_digits=ks_digits), "cpu")


def ckpt(pkg):
    return ref_ckpt if pkg == "ref" else port_ckpt


def load(pkg, what, path):
    fn = getattr(ckpt(pkg), f"load_{what}")
    return fn(path) if pkg == "ref" else fn(path, device="cpu")


def words(x):
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def key_words(ctx, secret=True):
    """{file array name: words} of a context of either package."""
    if isinstance(ctx, RlweKeys):
        keys = dict(ctx._keys)
    else:
        keys = {f"galois_{g}": pair for g, pair in ctx.galois_keys.items()}
        if ctx.relin_key is not None:
            keys["relin"] = ctx.relin_key
    out = {"pk_b_ntt": words(ctx.pk_b_ntt), "pk_a_ntt": words(ctx.pk_a_ntt)}
    for key_id, (b, a) in keys.items():
        out[f"{key_id}_b"], out[f"{key_id}_a"] = words(b), words(a)
    if secret:
        out["s_coeffs"] = np.asarray(ctx.s_coeffs, dtype=np.int64)
    return out


def assert_same_keys(a, b, secret=True):
    ka, kb = key_words(a, secret), key_words(b, secret)
    assert sorted(ka) == sorted(kb)
    for name in ka:
        assert np.array_equal(ka[name], kb[name]), name


def move(ct, src, dst, tmp_path, ckks_ct=False):
    """A ciphertext of package `src` as one of `dst`, through a file."""
    kind = "ckks_ciphertext" if ckks_ct else "ciphertext"
    path = str(tmp_path / (f"moved_{src}.npz" if ckks_ct
                           else f"moved_{src}.npy"))
    getattr(ckpt(src), f"save_{kind}")(ct, path)
    return load(dst, kind, path)


def both_read(path, what="context"):
    """The file read by each package: (reference context, port context)."""
    return load("ref", what, path), load("port", what, path)


def assert_next_encryption_equal(ref_ctx, port_ctx, values):
    a = ref_ctx.encrypt(ref_ctx.encode(values))
    b = port_ctx.encrypt(port_ctx.encode(values))
    np.testing.assert_array_equal(words(a.data), words(b.data))
    return a, b


# --------------------------------------------------------------- circuit

@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_circuit_roundtrip(tmp_path, writer, reader):
    """tests/test_cli_checkpoint.py::test_circuit_roundtrip across packages;
    both packages write the same JSON for the same program."""
    pkgs = {"ref": abc_tpu, "port": abc_tpu_torch}
    compiled = {}
    for name, pkg in pkgs.items():
        inputs = pkg.Parser.parse("secret int x = {1,2,3};")
        compiled[name] = pkg.compile_program(
            "x = x *** x; return x;", pkg.input_types_from_ast(inputs))
        ckpt(name).save_circuit(compiled[name],
                                str(tmp_path / f"circuit_{name}.json"))
    payloads = [json.loads((tmp_path / f"circuit_{name}.json").read_text())
                for name in pkgs]
    assert payloads[0] == payloads[1]
    restored = ckpt(reader).load_circuit(
        str(tmp_path / f"circuit_{writer}.json"))
    assert str(restored.ast) == str(compiled[writer].ast)
    assert restored.input_types["x"].secret
    assert restored.aux is None


# ----------------------------------------------------------- BFV context

@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_context_and_ciphertext_roundtrip(tmp_path, writer, reader):
    ctx = bfv(writer, 1024, seed=11)
    ctx.get_relin_key()
    ctx.get_galois_key(3)
    ct = ctx.encrypt(ctx.encode([4, 5, 6]))
    ctx_path, ct_path = str(tmp_path / "ctx.npz"), str(tmp_path / "ct.npy")
    ckpt(writer).save_context(ctx, ctx_path)
    ckpt(writer).save_ciphertext(ct, ct_path)

    ctx2 = load(reader, "context", ctx_path)
    ct2 = load(reader, "ciphertext", ct_path)
    assert_same_keys(ctx, ctx2)
    np.testing.assert_array_equal(words(ct2.data), words(ct.data))
    # restored context decrypts the restored ciphertext
    assert ctx2.decode(ctx2.decrypt(ct2))[:3] == [4, 5, 6]
    # restored keys still work: multiply + rotate, decrypted by the original
    prod = ctx2.multiply(ct2, ct2)
    rot = ctx2.rotate_rows(prod, 1)
    back = move(rot, reader, writer, tmp_path)
    assert ctx.decode(ctx.decrypt(back))[:2] == [25, 36]
    # both packages' readings of the file: the next encryption and the
    # product are the same words
    ref_ctx, port_ctx = both_read(ctx_path)
    a, b = assert_next_encryption_equal(ref_ctx, port_ctx, [1, 2, 3])
    np.testing.assert_array_equal(
        words(ref_ctx.rotate_rows(ref_ctx.multiply(a, a), 1).data),
        words(port_ctx.rotate_rows(port_ctx.multiply(b, b), 1).data))


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_seeded_context_checkpoint_roundtrip(tmp_path, writer, reader):
    """The uniform halves are left out and regenerated from the public seed
    (on the port's device), word for word; the payload shrinks below 0.65 of
    the full file."""
    import os
    ctx = bfv(writer, 1024, seed=321)
    ctx.get_relin_key()
    g = pow(3, 1, 2 * 1024)
    ctx.get_galois_key(g)
    ct = ctx.encrypt(ctx.encode([7, 8, 9]))
    full, comp = str(tmp_path / "full.npz"), str(tmp_path / "seeded.npz")
    ckpt(writer).save_context(ctx, full)
    ckpt(writer).save_context(ctx, comp, seeded=True)
    assert os.path.getsize(comp) < 0.65 * os.path.getsize(full)
    assert "pk_a_ntt" not in np.load(comp).files

    back = load(reader, "context", comp)
    assert_same_keys(ctx, back)
    # functional: the restored context decrypts the original's ciphertext
    ct_r = move(ct, writer, reader, tmp_path)
    assert back.decode(back.decrypt(ct_r))[:3] == [7, 8, 9]
    ref_ctx, port_ctx = both_read(comp)
    assert_next_encryption_equal(ref_ctx, port_ctx, [7, 8, 9])


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_seeded_checkpoint_without_params_seed(tmp_path, writer, reader):
    """A master seed drawn from OS entropy: the stored public seed carries
    the regeneration."""
    ctx = bfv(writer, 1024, seed=None)
    ctx.get_relin_key()
    p = str(tmp_path / "ctx.npz")
    ckpt(writer).save_context(ctx, p, seeded=True)
    back = load(reader, "context", p)
    assert_same_keys(ctx, back)
    ct = move(ctx.encrypt(ctx.encode([3, 4])), writer, reader, tmp_path)
    assert back.decode(back.decrypt(back.multiply(ct, ct)))[:2] == [9, 16]


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_seed_none_checkpoint_round_trip(tmp_path, writer, reader):
    """tests/test_advisor_r4_regressions.py::
    test_jx32_seed_none_checkpoint_round_trip: the reader's constructor
    draws different keys, and every path must use the restored ones (the
    reference writes from its jx32 engine, as there)."""
    ctx = bfv(writer, 1024, seed=None, engine="jx32")
    ct = ctx.encrypt(ctx.encode([4, 5, 6]))
    p = str(tmp_path / "ctx.npz")
    ckpt(writer).save_context(ctx, p, seeded=True)
    back = load(reader, "context", p)
    assert_same_keys(ctx, back)
    ct_r = move(ct, writer, reader, tmp_path)
    assert back.decode(back.decrypt(ct_r))[:3] == [4, 5, 6]
    ct2 = back.encrypt(back.encode([7, 8]))
    assert ctx.decode(ctx.decrypt(move(ct2, reader, writer, tmp_path)))[:2] \
        == [7, 8]
    # switching keys built after the load target the restored secret
    prod = back.multiply(ct_r, ct2)
    assert back.decode(back.decrypt(prod))[:2] == [28, 40]


# ---------------------------------------------------------- CKKS context

@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_ckks_context_roundtrip(tmp_path, writer, reader):
    ctx = ckks(writer, 512, levels=3, seed=21)
    ctx.get_relin_key()
    vals = np.linspace(-1, 1, 256)
    ct = ctx.multiply(ctx.encrypt(ctx.encode(vals)),
                      ctx.encrypt(ctx.encode(vals)))
    cpath, tpath = str(tmp_path / "ckks_ctx.npz"), str(tmp_path / "ct.npz")
    ckpt(writer).save_ckks_context(ctx, cpath)
    ckpt(writer).save_ckks_ciphertext(ct, tpath)
    ctx2 = load(reader, "ckks_context", cpath)
    ct2 = load(reader, "ckks_ciphertext", tpath)
    assert_same_keys(ctx, ctx2)
    np.testing.assert_array_equal(words(ct2.data), words(ct.data))
    assert (ct2.level, ct2.scale) == (ct.level, ct.scale)
    got = ctx2.decode(ctx2.decrypt(ct2)).real
    np.testing.assert_allclose(got, vals * vals, atol=2e-2)
    ref_ctx, port_ctx = both_read(cpath, "ckks_context")
    a, b = assert_next_encryption_equal(ref_ctx, port_ctx, vals[:8])
    np.testing.assert_array_equal(words(ref_ctx.multiply(a, a).data),
                                  words(port_ctx.multiply(b, b).data))


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_seeded_ckks_checkpoint_roundtrip(tmp_path, writer, reader):
    ctx = ckks(writer, 512, levels=2, seed=55)
    ctx.get_relin_key()
    ctx.get_galois_key(3)
    p = str(tmp_path / "ckks.npz")
    ckpt(writer).save_ckks_context(ctx, p, seeded=True)
    back = load(reader, "ckks_context", p)
    assert_same_keys(ctx, back)
    ref_ctx, port_ctx = both_read(p, "ckks_context")
    a, b = assert_next_encryption_equal(ref_ctx, port_ctx, [0.5, -1.25])
    np.testing.assert_array_equal(words(ref_ctx.rotate(a, 1).data),
                                  words(port_ctx.rotate(b, 1).data))


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_seed_none_ckks_checkpoint_round_trip(tmp_path, writer, reader):
    """tests/test_advisor_r4_regressions.py::
    test_jx32_seed_none_ckks_checkpoint_round_trip across packages."""
    ctx = ckks(writer, 512, levels=2, seed=None, engine="jx32")
    vals = [1.5, -2.25, 3.0]
    ct = ctx.encrypt(ctx.encode(vals))
    p = str(tmp_path / "ckks.npz")
    ckpt(writer).save_ckks_context(ctx, p, seeded=True)
    back = load(reader, "ckks_context", p)
    assert_same_keys(ctx, back)
    got = back.decode(back.decrypt(
        move(ct, writer, reader, tmp_path, ckks_ct=True))).real
    assert np.allclose(got[:3], vals, atol=1e-3)


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_hybrid_checkpoint_roundtrip(tmp_path, writer, reader):
    """tests/test_ckks.py::test_hybrid_checkpoint_roundtrip (k=2) across
    packages; the product of the restored context is the same words in
    both."""
    ctx = ckks(writer, 256, levels=4, seed=3, ks_digits=2)
    ct = ctx.encrypt(ctx.encode([4.5, -1.0]))
    ctx.get_relin_key()
    path = str(tmp_path / "ckks_k2.npz")
    ckpt(writer).save_ckks_context(ctx, path)
    ctx2 = load(reader, "ckks_context", path)
    assert ctx2.params.ks_digits == 2
    assert_same_keys(ctx, ctx2)
    ct_r = move(ct, writer, reader, tmp_path, ckks_ct=True)
    got = np.real(ctx2.decode(ctx2.decrypt(ctx2.multiply(ct_r, ct_r))))[:2]
    np.testing.assert_allclose(got, [20.25, 1.0], rtol=1e-3, atol=1e-3)
    ref_ctx, port_ctx = both_read(path, "ckks_context")
    ct_ref = load("ref", "ckks_ciphertext", str(tmp_path /
                                                  f"moved_{writer}.npz"))
    ct_port = load("port", "ckks_ciphertext", str(tmp_path /
                                                    f"moved_{writer}.npz"))
    np.testing.assert_array_equal(
        words(ref_ctx.multiply(ct_ref, ct_ref).data),
        words(port_ctx.multiply(ct_port, ct_port).data))


# -------------------------------------------- the port's two differences

def test_public_file_carries_no_seed_and_its_context_no_secret(tmp_path):
    """(a) A file without the secret has "seed": null (the reference
    writes the master seed, and its loader regenerates the secret from it).
    The server's context encrypts and evaluates with the held keys; decrypt,
    the noise budget and a key build raise; the client decrypts."""
    client = bfv("port", 1024, seed=5)
    client.get_relin_key()
    client.get_galois_key(3)
    p = str(tmp_path / "public.npz")
    port_ckpt.save_context(client, p, include_secret_key=False, seeded=True)
    data = np.load(p)
    assert json.loads(str(data["__meta__"]))["seed"] is None
    assert sorted(data.files) == ["__meta__", "galois_3_b", "pk_b_ntt",
                                  "relin_b"]
    server = port_ckpt.load_context(p, device="cpu")
    assert server.s_coeffs is None and server.s_ntt_full is None
    assert_same_keys(client, server, secret=False)
    ct = move(client.encrypt(client.encode([3, 4])), "port", "port",
              tmp_path)
    out = server.rotate_rows(server.multiply(ct, ct), 1)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.decrypt(out)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.noise_budget(out)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.get_galois_key(5)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        port_ckpt.save_context(server, str(tmp_path / "again.npz"))
    assert client.decode(client.decrypt(out))[:1] == [16]
    fresh = server.encrypt(server.encode([6]))
    assert client.decode(client.decrypt(fresh))[:1] == [6]
    # the reference reads the public keys of the port's file
    assert_same_keys(client, ref_ckpt.load_context(p), secret=False)


def test_public_reference_file_gives_the_port_no_secret(tmp_path):
    """(a) on a file the reference wrote: its meta names the master seed,
    and the port's context still holds no secret."""
    client = bfv("ref", 1024, seed=6)
    client.get_relin_key()
    p = str(tmp_path / "public.npz")
    ref_ckpt.save_context(client, p, include_secret_key=False)
    assert json.loads(str(np.load(p)["__meta__"]))["seed"] == 6
    server = port_ckpt.load_context(p, device="cpu")
    assert_same_keys(client, server, secret=False)
    ct = move(client.encrypt(client.encode([5])), "ref", "port", tmp_path)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.decrypt(ct)
    out = move(server.multiply(ct, ct), "port", "ref", tmp_path)
    assert client.decode(client.decrypt(out))[:1] == [25]


def test_public_ckks_file_gives_a_context_without_secret(tmp_path):
    client = ckks("port", 512, levels=2, seed=8)
    client.get_relin_key()
    p = str(tmp_path / "public.npz")
    port_ckpt.save_ckks_context(client, p, include_secret_key=False)
    assert json.loads(str(np.load(p)["__meta__"]))["seed"] is None
    server = port_ckpt.load_ckks_context(p, device="cpu")
    ct = server.encrypt(server.encode([1.5, -0.5]))
    out = server.multiply(ct, ct)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.decrypt(out)
    with pytest.raises(RuntimeExecutionError, match="no secret"):
        server.get_galois_key(3)
    got = np.real(client.decode(client.decrypt(out)))[:2]
    np.testing.assert_allclose(got, [2.25, 0.25], atol=1e-2)


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_two_seeded_round_trips_of_a_seedless_context(tmp_path, scheme):
    """(b) The loaded context keeps the file's public seed: a second seeded
    save regenerates the same halves (the reference's stores a fresh seed,
    and its keys then decrypt [3, 4]² to noise)."""
    if scheme == "bfv":
        ctx = bfv("port", 1024, seed=None)
        save, what = port_ckpt.save_context, "context"
    else:
        ctx = ckks("port", 512, levels=2, seed=None)
        save, what = port_ckpt.save_ckks_context, "ckks_context"
    ctx.get_relin_key()
    ct = ctx.encrypt(ctx.encode([3, 4]))
    back = ctx
    for i in range(2):
        path = str(tmp_path / f"round{i}.npz")
        save(back, path, seeded=True)
        back = load("port", what, path)
        assert back.public_seed == ctx.public_seed
    assert_same_keys(ctx, back)
    # the reference reads the second file to the same keys
    assert_same_keys(ctx, load("ref", what, path))
    prod = back.multiply(ct, ct)
    if scheme == "bfv":
        assert back.decode(back.decrypt(prod))[:2] == [9, 16]
    else:
        np.testing.assert_allclose(
            np.real(back.decode(back.decrypt(prod)))[:2], [9, 16], atol=1e-2)


def test_seeded_save_refuses_halves_its_public_seed_does_not_make(tmp_path):
    """A full reference file of a seedless context names no public seed; the
    port's context then cannot regenerate its halves, and a seeded save
    says so instead of writing keys that decrypt to noise. The port's own
    full files carry the public seed and save seeded again."""
    ref = bfv("ref", 1024, seed=None)
    ref.get_relin_key()
    p = str(tmp_path / "full.npz")
    ref_ckpt.save_context(ref, p)
    loaded = port_ckpt.load_context(p, device="cpu")
    assert_same_keys(ref, loaded)
    with pytest.raises(RuntimeExecutionError, match="seeded save"):
        port_ckpt.save_context(loaded, str(tmp_path / "s.npz"), seeded=True)
    port_ckpt.save_context(loaded, str(tmp_path / "full2.npz"))
    again = port_ckpt.load_context(str(tmp_path / "full2.npz"), device="cpu")
    port_ckpt.save_context(again, str(tmp_path / "s2.npz"), seeded=False)
    port = bfv("port", 1024, seed=None)
    port.get_relin_key()
    port_ckpt.save_context(port, str(tmp_path / "port_full.npz"))
    back = port_ckpt.load_context(str(tmp_path / "port_full.npz"),
                                  device="cpu")
    port_ckpt.save_context(back, str(tmp_path / "port_seeded.npz"),
                           seeded=True)
    assert_same_keys(port, port_ckpt.load_context(
        str(tmp_path / "port_seeded.npz"), device="cpu"))


def test_load_puts_the_context_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ctx = bfv("port", 1024, seed=1)
    p = str(tmp_path / "ctx.npz")
    port_ckpt.save_context(ctx, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ckpt.load_context(p)
    port_ckpt.save_ciphertext(ctx.encrypt(ctx.encode([1])),
                              str(tmp_path / "ct.npy"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ckpt.load_ciphertext(str(tmp_path / "ct.npy"))
    c = ckks("port", 256, levels=2, seed=1)
    port_ckpt.save_ckks_context(c, str(tmp_path / "ckks.npz"))
    port_ckpt.save_ckks_ciphertext(c.encrypt(c.encode([1.0])),
                                   str(tmp_path / "ckks_ct.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ckpt.load_ckks_context(str(tmp_path / "ckks.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ckpt.load_ckks_ciphertext(str(tmp_path / "ckks_ct.npz"))


def test_client_and_server_through_files_only(tmp_path):
    """chip_smoke.py phase 11 on the CPU at small n: the client writes the
    circuit, the public seeded context and two requests per scheme; the
    server (chip_smoke.serve) reads only those files, serves them through
    JittedProgram.run_raw with a context that holds no secret and builds no
    key, and the client decrypts its outputs to the oracle, word for word
    its own run on the same ciphertexts."""
    import warnings

    import chip_smoke
    gold = chip_smoke.golden()
    small = {"hamming_n8192": dict(gold["hamming_n8192"], n=1024),
             "ckks_mult_relin_n32768_k2": dict(
                 gold["ckks_mult_relin_n32768_k2"], n=1024)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # dev sizes warn on security
        client, sizes = chip_smoke.client_files(str(tmp_path), "cpu", small)
        report = chip_smoke.serve(str(tmp_path), "cpu")
    chip_smoke.check_served(str(tmp_path), client, report, "cpu")
    for scheme, rec in report.items():
        assert sizes[scheme]["seeded"] < 0.65 * sizes[scheme]["full"]
        assert rec["keys"] == sorted(client[scheme][0].factory.context._keys)
        meta = json.loads(str(np.load(
            tmp_path / f"{scheme}_seeded.npz")["__meta__"]))
        assert meta["seed"] is None
