"""Execution engines: the HEALPix shell runners and the Cartesian grid
runners."""

from . import HealpixRunner
from . import Map2DRunner
from .HealpixRunner import (DefaultRunner, BaryonifyShell, PaintProfilesShell,
                            PaintProfilesAnisShell)
from .Map2DRunner import (DefaultRunnerGrid, BaryonifyGrid, PaintProfilesGrid,
                          PaintProfilesAnisGrid)
