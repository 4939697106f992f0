"""Data/IO objects feeding the Runners (reference utils/io.py analog).

Host-side containers (numpy), the same classes as ``baryonforge_tpu.utils.io``
(that package cannot be imported without jax). Runners move what they need
to the device. The cosmology dict is validated with the same required keys
as the reference (io.py:56-129): Omega_m, sigma8, h, Omega_b, n_s, w0.
"""

import numpy as np

__all__ = ["HaloLightConeCatalog", "HaloNDCatalog", "LightconeShell",
           "GriddedMap", "ParticleSnapshot"]

_REQUIRED_COSMO = ("Omega_m", "sigma8", "h", "Omega_b", "n_s", "w0")


def _check_cosmo(cosmo):
    cosmo = dict(cosmo)
    cosmo.setdefault("w0", -1.0)
    cosmo.setdefault("wa", 0.0)
    missing = [k for k in _REQUIRED_COSMO if k not in cosmo]
    if missing:
        raise ValueError(f"cosmo dict missing keys: {missing}")
    return cosmo


class HaloLightConeCatalog:
    """Halo catalog on the sky: ra, dec [deg], M [Msun], z + extra columns."""

    def __init__(self, ra=None, dec=None, M=None, z=None, cosmo=None,
                 **arrays):
        ra, dec = np.atleast_1d(ra), np.atleast_1d(dec)
        M, z = np.atleast_1d(M), np.atleast_1d(z)
        if not ra.size == dec.size == M.size == z.size:
            raise ValueError("ra, dec, M and z must have the same length")

        # pole-dec clipping (reference io.py behavior): avoid exactly ±90
        dec = np.clip(dec, -90 + 1e-10, 90 - 1e-10)

        dtypes = [("ra", float), ("dec", float), ("M", float), ("z", float)]
        for k, v in arrays.items():
            v = np.atleast_1d(v)
            if v.shape[0] != ra.size:
                raise ValueError(f"extra column {k} wrong length")
            dtypes.append((k, v.dtype, v.shape[1:]) if v.ndim > 1
                          else (k, v.dtype))
        cat = np.zeros(ra.size, dtype=dtypes)
        cat["ra"], cat["dec"], cat["M"], cat["z"] = ra, dec, M, z
        for k, v in arrays.items():
            cat[k] = np.atleast_1d(v)
        self.cat = cat
        self.cosmology = _check_cosmo(cosmo)

    def __len__(self):
        return self.cat.size

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.cat[key]
        new = object.__new__(HaloLightConeCatalog)
        new.cat = np.atleast_1d(self.cat[key])
        new.cosmology = self.cosmology
        return new

    @property
    def data(self):
        return self.cat


class HaloNDCatalog:
    """Cartesian halo catalog: x, y [, z] in comoving Mpc + M, at a single
    snapshot ``redshift``. Extra columns may be vector-valued."""

    def __init__(self, x=None, y=None, M=None, redshift=None, cosmo=None,
                 z=None, **arrays):
        x, y, M = np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(M)
        is2D = z is None
        dtypes = [("x", float), ("y", float), ("z", float), ("M", float)]
        for k, v in arrays.items():
            v = np.atleast_1d(v)
            dtypes.append((k, v.dtype, v.shape[1:]) if v.ndim > 1
                          else (k, v.dtype))
        cat = np.zeros(x.size, dtype=dtypes)
        cat["x"], cat["y"], cat["M"] = x, y, M
        cat["z"] = 0.0 if is2D else np.atleast_1d(z)
        for k, v in arrays.items():
            cat[k] = np.atleast_1d(v)
        self.cat = cat
        self.is2D = is2D
        self.redshift = redshift
        self.cosmology = _check_cosmo(cosmo)

    def __len__(self):
        return self.cat.size

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.cat[key]
        new = object.__new__(HaloNDCatalog)
        new.cat = np.atleast_1d(self.cat[key])
        new.is2D = self.is2D
        new.redshift = self.redshift
        new.cosmology = self.cosmology
        return new


class LightconeShell:
    """HEALPix (ring-ordered) map + cosmo dict (reference io.py:341-363)."""

    def __init__(self, map=None, cosmo=None, redshift=None, path=None):
        if map is None and path is not None:
            if str(path).lower().endswith((".fits", ".fit", ".fits.gz")):
                raise NotImplementedError(
                    "FITS shells are not ported yet (ROADMAP Queue 1 item "
                    "14, utils/fitsio); load the map and pass map=")
            map = np.load(path)
        if map is None:
            raise ValueError("provide map array (or path to .npy)")
        self.map = np.asarray(map, dtype=np.float64)
        nside = int(np.sqrt(self.map.size / 12))
        if 12 * nside * nside != self.map.size:
            raise ValueError(
                f"map size {self.map.size} is not a valid healpix size")
        self.NSIDE = nside
        self.redshift = redshift
        self.cosmology = _check_cosmo(cosmo)


class GriddedMap:
    """2D/3D square/cubic grid map with pixel-center ``bins`` in comoving
    Mpc (reference io.py:450-478)."""

    def __init__(self, map=None, bins=None, cosmo=None, redshift=None):
        self.map = np.asarray(map, dtype=np.float64)
        self.bins = np.asarray(bins, dtype=np.float64)
        self.is2D = self.map.ndim == 2
        self.Npix = self.map.shape[0]
        if any(s != self.Npix for s in self.map.shape):
            raise ValueError("map must be square/cubic")
        self.res = self.bins[1] - self.bins[0]
        self.L = self.res * self.Npix
        self.redshift = redshift
        self.cosmology = _check_cosmo(cosmo)
        if self.is2D:
            self.grid = np.meshgrid(self.bins, self.bins, indexing="ij")
        else:
            self.grid = np.meshgrid(self.bins, self.bins, self.bins,
                                    indexing="ij")
        self.inds = np.arange(self.map.size).reshape(self.map.shape)


class ParticleSnapshot:
    """Particle snapshot: positions, masses, periodic box L
    (reference io.py:586-677)."""

    def __init__(self, x=None, y=None, z=None, M=None, L=None, cosmo=None,
                 redshift=None):
        self.x = np.atleast_1d(x)
        self.y = np.atleast_1d(y)
        self.is2D = z is None
        self.z = None if self.is2D else np.atleast_1d(z)
        self.M = np.atleast_1d(M)
        self.L = float(L)
        self.redshift = redshift
        self.cosmology = _check_cosmo(cosmo)
        names = ["x", "y", "M"] if self.is2D else ["x", "y", "z", "M"]
        cat = np.zeros(self.x.size, dtype=[(n, float) for n in names])
        cat["x"], cat["y"], cat["M"] = self.x, self.y, self.M
        if not self.is2D:
            cat["z"] = self.z
        self.cat = cat

    def make_map(self, N_grid):
        """Mass histogram map of the particles (reference make_map)."""
        coords = ([self.cat["x"], self.cat["y"]] if self.is2D
                  else [self.cat["x"], self.cat["y"], self.cat["z"]])
        sample = np.stack(coords, axis=1)
        edges = np.linspace(0, self.L, N_grid + 1)
        H, _ = np.histogramdd(sample, bins=[edges] * sample.shape[1],
                              weights=self.cat["M"])
        return H
