# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Utilities (counterpart of `tiny_deepspeed_tpu/utils/`): checkpoint
and resume."""
