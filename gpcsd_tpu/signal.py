"""Signal processing for the workload pipelines, in JAX.

The reference pipelines lean on scipy.signal for phase extraction:
- Butterworth bandpass + ``filtfilt`` 8-12 Hz (``auditory_lfp/
  fit_gpcsd_baseline.py:292-308``), ``sosfiltfilt`` theta/beta bands
  (``neuropixels/fit_gpcsd2d.py:140-159``)
- ``hilbert`` -> instantaneous phases, PLV matrices
  (``fit_gpcsd_baseline.py:303-322``)
- periodograms (``fit_gpcsd_baseline.py:189-269``)

Filter *design* stays on the host (scipy, static coefficients);
filter *application* is a ``lax.scan`` over time (second-order sections,
direct-form II transposed) with all channel/trial axes batched, and the
spectral ops ride ``jnp.fft``.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as _ss


def butter_bandpass_sos(low_hz, high_hz, fs, order=4):
    """Design a Butterworth bandpass as second-order sections (host-side)."""
    return np.asarray(
        _ss.butter(order, [low_hz, high_hz], btype="bandpass", fs=fs, output="sos")
    )


def sosfilt(sos, x, axis=-1, zi=None):
    """Causal SOS filter along ``axis``; direct-form II transposed scan.

    :param zi: optional initial conditions, broadcastable to (nsec, B, 2)
        where B is the flattened batch size.
    """
    sos = jnp.asarray(sos)
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    batch = x.shape[:-1]
    n = x.shape[-1]
    xf = x.reshape(-1, n)  # (B, n)
    nsec = sos.shape[0]
    B = xf.shape[0]

    def step(state, xt):
        # state: (nsec, B, 2); xt: (B,)
        y = xt
        new_states = []
        for s in range(nsec):
            b0, b1, b2, a0, a1, a2 = [sos[s, i] for i in range(6)]
            z1 = state[s, :, 0]
            z2 = state[s, :, 1]
            out = b0 * y + z1
            z1n = b1 * y - a1 * out + z2
            z2n = b2 * y - a2 * out
            new_states.append(jnp.stack([z1n, z2n], axis=-1))
            y = out
        return jnp.stack(new_states), y

    if zi is None:
        init = jnp.zeros((nsec, B, 2), x.dtype)
    else:
        init = jnp.broadcast_to(jnp.asarray(zi, x.dtype), (nsec, B, 2))
    _, ys = jax.lax.scan(step, init, xf.T)  # ys: (n, B)
    y = ys.T.reshape(*batch, n)
    return jnp.moveaxis(y, -1, axis)


def sosfiltfilt(sos, x, axis=-1, padlen=None):
    """Zero-phase forward-backward SOS filtering with odd-reflection padding
    (matches scipy.signal.sosfiltfilt's default padding semantics)."""
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    nsec = np.asarray(sos).shape[0]
    if padlen is None:
        padlen = 3 * (2 * nsec + 1)  # scipy default
    padlen = min(padlen, n - 1)
    # steady-state initial conditions per section (scipy sosfilt_zi), scaled
    # by the first sample of each pass — matches scipy.signal.sosfiltfilt
    zi0 = _ss.sosfilt_zi(np.asarray(sos))  # (nsec, 2)
    zi0 = jnp.asarray(zi0)[:, None, :]  # (nsec, 1, 2) -> broadcast over batch
    # odd extension: 2*x[0] - x[pad:0:-1] ... on both ends
    left = 2 * x[..., :1] - x[..., padlen:0:-1]
    right = 2 * x[..., -1:] - x[..., -2 : -padlen - 2 : -1]
    ext = jnp.concatenate([left, x, right], axis=-1)

    def _pass(v):
        x0 = v[..., :1].reshape(1, -1, 1)  # (1, B, 1)
        return sosfilt(sos, v, axis=-1, zi=zi0 * x0)

    y = _pass(ext)
    y = _pass(y[..., ::-1])
    y = y[..., ::-1]
    y = y[..., padlen : padlen + n]
    return jnp.moveaxis(y, -1, axis)


def bandpass_filtfilt(x, low_hz, high_hz, fs, order=4, axis=-1):
    """Zero-phase Butterworth bandpass (design on host, apply in JAX)."""
    sos = butter_bandpass_sos(low_hz, high_hz, fs, order=order)
    return sosfiltfilt(sos, x, axis=axis)


def hilbert(x, axis=-1):
    """Analytic signal via FFT (scipy.signal.hilbert semantics)."""
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    Xf = jnp.fft.fft(x, axis=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    xa = jnp.fft.ifft(Xf * jnp.asarray(h), axis=-1)
    return jnp.moveaxis(xa, -1, axis)


def instantaneous_phase(x, axis=-1):
    """Angle of the analytic signal."""
    return jnp.angle(hilbert(x, axis=axis))


def plv_matrix(phases):
    """Phase-locking value matrix from (nchan, ntrials) phases at one time:
    PLV[i, j] = |mean_trials exp(i (phi_i - phi_j))| (reference
    ``fit_gpcsd_baseline.py:311-322``)."""
    phases = jnp.asarray(phases)
    z = jnp.exp(1j * phases)  # (nchan, ntrials)
    G = z @ jnp.conj(z).T / phases.shape[1]
    return jnp.abs(G)


def periodogram(x, fs=1.0, axis=-1, detrend=True):
    """One-sided periodogram (scipy.signal.periodogram semantics, boxcar
    window, density scaling).  Returns (freqs, pxx)."""
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if detrend:
        x = x - jnp.mean(x, axis=-1, keepdims=True)
    Xf = jnp.fft.rfft(x, axis=-1)
    pxx = (jnp.abs(Xf) ** 2) / (fs * n)
    if n % 2 == 0:
        scale = jnp.concatenate(
            [jnp.ones(1), 2 * jnp.ones(pxx.shape[-1] - 2), jnp.ones(1)]
        )
    else:
        scale = jnp.concatenate([jnp.ones(1), 2 * jnp.ones(pxx.shape[-1] - 1)])
    pxx = pxx * scale
    freqs = jnp.asarray(np.fft.rfftfreq(n, 1.0 / fs))
    return freqs, jnp.moveaxis(pxx, -1, axis)
