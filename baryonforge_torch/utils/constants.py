"""Physical constants in the two unit systems used throughout the package.

Mirrors the constant set of the reference implementation
(BaryonForge/utils/constants.py:5-26) but is an independent transcription of
standard CODATA / astronomical values.

Two systems:
  * "cosmology" units: masses in Msun, lengths in Mpc, velocities in km/s.
  * CGS units (suffix ``_CGS``): cm / g / s / erg / K.
"""

import numpy as np

# ----------------------------------------------------------------------------
# Base conversions
# ----------------------------------------------------------------------------
Mpc_to_m   = 3.085677581491367e22    # meters per Mpc (IAU 2015)
Mpc_to_cm  = Mpc_to_m * 100.0
Msun_to_kg = 1.98892e30              # kg per solar mass
Msun_to_g  = Msun_to_kg * 1000.0

# ----------------------------------------------------------------------------
# Cosmology units (Msun, Mpc, s unless stated)
# ----------------------------------------------------------------------------
G         = 6.6743e-11 / Mpc_to_m**3 * Msun_to_kg     # Mpc^3 / (Msun s^2)
C_LIGHT   = 299792.458                                 # km/s
C_MPC_S   = C_LIGHT * 1.0e3 / Mpc_to_m                 # Mpc / s

# rho_crit(z=0) / h^2 = 3 (100 km/s/Mpc)^2 / (8 pi G) in Msun / Mpc^3
RHO_CRIT_0_h2 = 3.0 * (100.0e3 / Mpc_to_m) ** 2 / (8.0 * np.pi * (6.6743e-11 / Mpc_to_m**3 * Msun_to_kg))

# ----------------------------------------------------------------------------
# CGS
# ----------------------------------------------------------------------------
G_CGS       = 6.6743e-8         # cm^3 / (g s^2)
K_BOLTZ_CGS = 1.380649e-16      # erg / K
SIGMA_T_CGS = 6.6524587321e-25  # Thomson cross-section, cm^2
M_ELECTRON_CGS = 9.1093837015e-28  # g
M_PROTON_CGS   = 1.67262192369e-24 # g
C_CGS       = 2.99792458e10     # cm / s

# ----------------------------------------------------------------------------
# Gas composition (same conventions as reference constants.py:23-26)
# ----------------------------------------------------------------------------
Y_HELIUM  = 0.24
# Ratio of thermal pressure to electron pressure for a fully ionised H+He gas
Pth_to_Pe = (4.0 - 2.0 * Y_HELIUM) / (8.0 - 5.0 * Y_HELIUM)
# Conversion P_gas -> P_e used in tSZ painting
Pgas_to_Pe = Pth_to_Pe
# Mean molecular weights
MEAN_MOLECULAR_WEIGHT    = 0.59   # fully ionised primordial plasma
MU_ELECTRON              = 2.0 / (2.0 - Y_HELIUM)  # ~1.14
