"""Encryption suite: AEAD keygen / encrypt / decrypt (reference
``encryption/bench.rs``, defaults 5 s + 10 s, lines tokens).

Cipher registry of (label, nonce_len, encrypt, decrypt) entries — the
reference's registry-of-triples shape (``encryption/bench.py:104-156``)
sweeping three AEADs (``encryption/bench.rs:87-125``): on-device
ChaCha20-Poly1305 and XChaCha20-Poly1305 (SURVEY.md K13), plus AES-256-GCM
as a host baseline via the ``cryptography`` library (the reference's
OpenSSL rows; skipped when it is not installed). Nonces are
counter-derived (reference ``encryption/bench.rs:87-125``); decryption
pre-encrypts the corpus once and reports plaintext-byte throughput
(``encryption/bench.rs:362-367``).

The corpus rows run through the chained-loop protocol: each iteration
salt-perturbs the key, streams the keystream-XOR over the carried
buffer, and converts + MACs the whole-block ciphertext through the
device Poly1305 partials kernel. Excluded from the chained region: the
O(n_blocks / 4096) host bigint fold that finishes the tag — ~4096x less
work than the data pipeline. Per-token rows advance a global nonce
counter across calls so no dispatch ever repeats.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from stringwars_tpu.ops import chacha as CC
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.utils.harness import (
    DeviceRoutine,
    WorkUnits,
    device_routine_factory,
    fold_salt,
)
from stringwars_tpu.utils.report import report_skip


def counter_nonce(i: int, size: int = 12) -> bytes:
    return i.to_bytes(size, "little")


def device_ciphers() -> list[tuple[str, int, object, object]]:
    """(label, nonce_len, encrypt(key, nonce, pt) -> (ct, tag),
    decrypt(key, nonce, ct, tag) -> pt) for the on-device AEADs."""
    return [
        ("swtpu::chacha20poly1305", 12, CC.aead_encrypt, CC.aead_decrypt),
        ("swtpu::xchacha20poly1305", 24, CC.xchacha_aead_encrypt, CC.xchacha_aead_decrypt),
    ]


def main() -> None:
    ctx = setup_suite(
        "AEAD throughput (ChaCha20/XChaCha20-Poly1305 on-device; AES-GCM host)",
        default_tokens="lines",
        default_warmup=5.0,
        default_time=10.0,
        default_synthetic="long-lines",
    )
    key = bytes(range(32))
    tokens = [t for t in ctx.tape.to_list() if t][:4096]
    sample = tokens[:64]
    sample_bytes = sum(map(len, sample))
    corpus = np.asarray(ctx.tape.data)[: ctx.tape.total_bytes]

    ctx.group("keygen")
    from stringwars_tpu.ops.memops import fill_random

    seed_box = [0]

    # Per-cipher keygen rows (reference measures key+nonce generation for
    # each AEAD, ``encryption/bench.rs:87-125``): a fresh 256-bit key plus
    # a cipher-sized nonce per call, from the device Threefry generator.
    for label, nlen, _encrypt, _decrypt in device_ciphers():

        def keygen_cipher(nlen=nlen) -> WorkUnits:
            seed_box[0] += 1
            np.asarray(fill_random(seed_box[0], 32 + nlen))
            return WorkUnits(elements=1, bytes=32 + nlen)

        ctx.run(f"keygen/{label}", "bytes", keygen_cipher)

    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        def keygen_host() -> WorkUnits:
            AESGCM.generate_key(bit_length=256)
            counter_nonce(seed_box[0], 12)
            return WorkUnits(elements=1, bytes=32 + 12)

        ctx.run("keygen/cryptography.AESGCM", "bytes", keygen_host)
    except ImportError:
        report_skip("keygen/cryptography.AESGCM", "cryptography not installed")

    def keygen() -> WorkUnits:
        seed_box[0] += 1
        np.asarray(fill_random(seed_box[0], 32))
        return WorkUnits(elements=1, bytes=32)

    ctx.run("keygen/swtpu::fill_random", "bytes", keygen)

    def aead_corpus_routine():
        """Chained ChaCha20-Poly1305 corpus pipeline: keystream-XOR the
        carried buffer with a salt-perturbed key, then device-MAC the
        whole-block ciphertext (limb conversion + Poly1305 partials).
        The same device work measures encrypt and decrypt (the cipher is
        an XOR; the MAC runs over ciphertext either way)."""
        n = int(corpus.shape[0])
        n_blocks = max((n + 63) // 64, 1)
        padded = np.zeros(n_blocks * 64, np.uint8)
        padded[:n] = corpus
        buf = jax.device_put(jnp.asarray(padded.view("<u4")))
        key8 = CC._key_words(key)
        nonce3 = jnp.asarray(np.frombuffer(counter_nonce(0, 12), "<u4"))
        # Any clamped r does identical limb arithmetic; throughput is
        # r-independent (conformance of the real tag path is in tests).
        r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
        rpowers_np, _ = CC._r_power_limbs(r)
        rpowers = jax.device_put(jnp.asarray(rpowers_np))
        mac_blocks = (n // 16) // CC._CHUNK * CC._CHUNK  # whole chunks of full blocks

        def body(s, buf_c, key8_, nonce3_, rp):
            out = CC._xor_keystream_u32(buf_c, key8_ ^ s, nonce3_, s, n_blocks)
            blocks = out[: mac_blocks * 4].reshape(mac_blocks, 4)
            limbs = CC.limbs_from_u32(blocks, jnp.ones((mac_blocks,), jnp.uint32))
            partials = CC._poly_chunk_partials(limbs, rp, mac_blocks // CC._CHUNK)
            return fold_salt(s, partials), out

        return DeviceRoutine(
            body=body,
            consts=(key8, nonce3, rpowers),
            units=WorkUnits(elements=1, bytes=n),
            extra0=buf,
        )

    ctx.group("encryption")
    nonce_ctr = [0]
    for label, nlen, encrypt, _decrypt in device_ciphers():
        # Per-token AEAD round-trips are dispatch-bound on an accelerator;
        # the corpus-level row below is the device-shaped measurement. The
        # nonce counter advances across calls so no two calls encrypt
        # under the same nonce.
        def encrypt_sample(encrypt=encrypt, nlen=nlen) -> WorkUnits:
            base = nonce_ctr[0]
            nonce_ctr[0] += len(sample)
            for i, token in enumerate(sample):
                encrypt(key, counter_nonce(base + i, nlen), token)
            return WorkUnits(elements=len(sample), bytes=sample_bytes)

        ctx.run(f"encryption/{label}<1chip>", "bytes", encrypt_sample)

    ctx.run(
        "encryption/swtpu::chacha20poly1305-corpus<1chip>",
        "bytes",
        device_routine_factory(aead_corpus_routine),
    )

    def xchacha_corpus_routine():
        # XChaCha differs only in the one-time HChaCha20 subkey derivation
        # (host-side, key-setup cost — covered by the keygen rows); the
        # streaming pipeline is the same chained body under the subkey.
        sub = CC._hchacha20(key, counter_nonce(7, 24)[:16])
        routine = aead_corpus_routine()
        key8 = CC._key_words(sub)
        return DeviceRoutine(
            body=routine.body,
            consts=(key8,) + routine.consts[1:],
            units=routine.units,
            extra0=routine.extra0,
        )

    ctx.run(
        "encryption/swtpu::xchacha20poly1305-corpus<1chip>",
        "bytes",
        device_routine_factory(xchacha_corpus_routine),
    )

    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM, ChaCha20Poly1305

        host_ciphers = [
            ("cryptography.AESGCM", AESGCM(key)),
            ("cryptography.ChaCha20Poly1305", ChaCha20Poly1305(key)),
        ]
        for label, cipher in host_ciphers:

            def host_routine(cipher=cipher) -> WorkUnits:
                for i, token in enumerate(sample):
                    cipher.encrypt(counter_nonce(i), token, None)
                return WorkUnits(elements=len(sample), bytes=sample_bytes)

            ctx.run(f"encryption/{label}", "bytes", host_routine)
    except ImportError:
        report_skip("encryption/cryptography.*", "cryptography not installed")

    ctx.group("decryption")
    # Open = the same device pipeline as seal (MAC over ciphertext, then
    # keystream-XOR back); the chained corpus body measures both. The rows
    # report plaintext-byte throughput like the reference's pre-encrypted
    # decryption group (encryption/bench.rs:362-367).
    ctx.run(
        "decryption/swtpu::chacha20poly1305-corpus<1chip>",
        "bytes",
        device_routine_factory(aead_corpus_routine),
    )
    ctx.run(
        "decryption/swtpu::xchacha20poly1305-corpus<1chip>",
        "bytes",
        device_routine_factory(xchacha_corpus_routine),
    )
    ctx.finish()


if __name__ == "__main__":
    main()
