"""``python -m office_person_detection_vit_torch.benchmark`` entry
(reference src/benchmark/__main__.py:9)."""

import sys

from . import main

sys.exit(main())
