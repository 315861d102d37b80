"""K13 conformance: ChaCha20-Poly1305 vs RFC 8439 vectors + OpenSSL."""

import numpy as np
import pytest
ChaCha20Poly1305 = pytest.importorskip(
    "cryptography.hazmat.primitives.ciphers.aead"
).ChaCha20Poly1305

from stringwars_tpu.ops.chacha import aead_decrypt, aead_encrypt, chacha20_xor, poly1305_tag


def test_chacha20_rfc8439_block():
    # RFC 8439 §2.4.2 test vector: key 00..1f, nonce 00 00 00 00 00 00 00 4a
    # 00 00 00 00 reordered per RFC: nonce = 000000000000004a00000000
    key = bytes(range(32))
    nonce = bytes.fromhex("000000000000004a00000000")
    plaintext = (
        b"Ladies and Gentlemen of the class of '99: If I could offer you "
        b"only one tip for the future, sunscreen would be it."
    )
    ct = np.asarray(chacha20_xor(key, nonce, np.frombuffer(plaintext, np.uint8), counter=1))
    want = bytes.fromhex(
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
        "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
        "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
        "5af90bbf74a35be6b40b8eedf2785e42874d"
    )
    assert ct.tobytes() == want


def test_poly1305_rfc8439():
    key = bytes.fromhex(
        "85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"
    )
    msg = b"Cryptographic Forum Research Group"
    assert poly1305_tag(key, msg) == bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 64, 1000, 65536, 200_000])
def test_aead_matches_openssl(rng, size):
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    nonce = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
    pt = bytes(rng.integers(0, 256, size, dtype=np.uint8))
    aad = b"header" if size % 2 else b""
    ct, tag = aead_encrypt(key, nonce, pt, aad)
    want = ChaCha20Poly1305(key).encrypt(nonce, pt, aad if aad else None)
    assert ct.tobytes() + tag == want


def test_aead_roundtrip_and_tamper(rng):
    key = bytes(32)
    nonce = bytes(12)
    pt = b"attack at dawn" * 100
    ct, tag = aead_encrypt(key, nonce, pt)
    out = aead_decrypt(key, nonce, ct, tag)
    assert out.tobytes() == pt
    bad = bytearray(tag)
    bad[0] ^= 1
    with pytest.raises(ValueError):
        aead_decrypt(key, nonce, ct, bytes(bad))


def test_hchacha20_regression_pin():
    # Subkey derivation pin for the draft-irtf-cfrg-xchacha §2.2.1 inputs.
    # The value is cross-validated end-to-end by the §A.3 AEAD vector below
    # (ciphertext + tag byte-exact), which any subkey error would scramble.
    from stringwars_tpu.ops.chacha import _hchacha20

    key = bytes.fromhex(
        "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f"
    )
    nonce16 = bytes.fromhex("000000090000004a0000000031415927")
    assert _hchacha20(key, nonce16) == bytes.fromhex(
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc"
    )


def test_xchacha20poly1305_draft_vector():
    # draft-irtf-cfrg-xchacha-03 §A.3
    from stringwars_tpu.ops.chacha import xchacha_aead_decrypt, xchacha_aead_encrypt

    pt = (
        b"Ladies and Gentlemen of the class of '99: If I could offer you "
        b"only one tip for the future, sunscreen would be it."
    )
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    key = bytes.fromhex(
        "808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f"
    )
    nonce24 = bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657")
    ct, tag = xchacha_aead_encrypt(key, nonce24, pt, aad)
    assert ct.tobytes() == bytes.fromhex(
        "bd6d179d3e83d43b9576579493c0e939572a1700252bfaccbed2902c21396cbb"
        "731c7f1b0b4aa6440bf3a82f4eda7e39ae64c6708c54c216cb96b72e1213b452"
        "2f8c9ba40db5d945b11b69b982c1bb9e3f3fac2bc369488f76b2383565d3fff9"
        "21f9664c97637da9768812f615c68b13b52e"
    )
    assert tag == bytes.fromhex("c0875924c1c7987947deafd8780acf49")
    out = xchacha_aead_decrypt(key, nonce24, ct, tag, aad)
    assert out.tobytes() == pt


def test_pallas_keystream_matches_xla_oracle():
    # The corpus rows' keystream-XOR over whole-block u32 buffers must equal
    # an independent XOR with the keystream blocks, from a nonzero counter.
    import jax.numpy as jnp

    from stringwars_tpu.ops.chacha import _key_words, _keystream, _xor_keystream_u32

    key = bytes(range(32))
    nonce = bytes(range(100, 112))
    n_blocks = 2048
    rng = np.random.default_rng(7)
    data = rng.integers(0, 1 << 32, n_blocks * 16, dtype=np.uint32)
    k8 = _key_words(key)
    n3 = jnp.asarray(np.frombuffer(nonce, "<u4"))
    ks = np.asarray(_keystream(k8, n3, jnp.uint32(5), n_blocks)).reshape(-1)
    out = np.asarray(_xor_keystream_u32(jnp.asarray(data), k8, n3, jnp.uint32(5), n_blocks))
    assert np.array_equal(out, data ^ ks)
    # Block 0 under counter 5 equals block 5 under counter 0.
    ks0 = np.asarray(_keystream(k8, n3, jnp.uint32(0), 6)).reshape(-1)
    assert np.array_equal(ks[:16], ks0[5 * 16 : 6 * 16])


def test_limbs_from_u32_matches_host():
    """Device whole-block limb conversion == the host _blocks_to_limbs
    (the chained AEAD corpus rows MAC through this path)."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.chacha import _blocks_to_limbs, limbs_from_u32

    rng = np.random.default_rng(11)
    msg = rng.integers(0, 256, 16 * 37, dtype=np.uint8)  # whole blocks only
    want, n_blocks = _blocks_to_limbs(msg)
    blocks = jnp.asarray(msg.view("<u4").reshape(n_blocks, 4))
    got = np.asarray(limbs_from_u32(blocks, jnp.ones((n_blocks,), jnp.uint32)))
    assert np.array_equal(got, want)
