"""Face-restoration helper: alignment, crop, and soft paste-back.

The port's own copy of ``lowlight_image_enhancement_tpu/utils/
face_util.py`` (numpy only; imports nothing of the JAX package).

Rebuild of the reference ``FaceRestorationHelper``
(``NAFNet_base/basicsr/utils/face_util.py:22-223``), the stock-BasicSR
face pipeline: detect faces, estimate a 5-landmark similarity transform to
the FFHQ template, warp-crop each face to ``face_size``, run restoration on
the crops, then warp the restored crops back and blend them over the
(upscaled) input with an eroded + Gaussian-feathered mask.

Differences from the reference, by design:

- **Landmark detection is pluggable.** The reference hard-requires dlib's
  CNN detector + shape predictors, whose model files cannot be downloaded
  in this environment. Here, ``detect_faces``/``get_face_landmarks_5``
  accept either a user-injected detector callable (``landmark_fn``) or
  precomputed landmarks (``set_landmarks_5``); a dlib adapter
  (:func:`make_dlib_landmark_fn`) is provided for parity when dlib and its
  model files are available.
- The similarity transform is an in-house Umeyama solve
  (:func:`estimate_similarity`) replacing
  ``skimage.transform.SimilarityTransform`` — same least-squares estimate.
- Warping/blending go through :mod:`.imgproc` (cv2 when importable,
  numpy/scipy with cv2-matched conventions otherwise), and image I/O
  through :mod:`.imgio` — no hard cv2 dependency.
- **Everything is RGB**, including restored faces and the returned
  composite. The reference composites in BGR purely as a cv2-convention
  artifact (``face_util.py:180-186``); this framework's tensor->image
  path is RGB throughout, so the helper is too.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

# 5-point FFHQ template for 1024x1024 faces (reference
# ``face_util.py:30-35``): eyes (outer/inner L, inner/outer R), mouth.
FFHQ_TEMPLATE_1024 = np.array(
    [
        [686.77227723, 488.62376238],
        [586.77227723, 493.59405941],
        [337.91089109, 488.38613861],
        [437.95049505, 493.51485149],
        [513.58415842, 678.5049505],
    ],
    dtype=np.float64,
)


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (Umeyama 1991): returns the
    ``[2, 3]`` affine matrix ``A`` with ``dst ~= src @ A[:, :2].T + A[:, 2]``.

    Matches ``skimage.transform.SimilarityTransform.estimate(...).params
    [0:2, :]`` as used by the reference (``face_util.py:146-148``).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError(f"landmark shapes mismatch: {src.shape} vs "
                         f"{dst.shape}")
    n = src.shape[0]
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / n                       # [2, 2]
    u, s, vt = np.linalg.svd(cov)
    d = np.ones(2)
    if np.linalg.det(cov) < 0 or (
        np.isclose(np.linalg.det(cov), 0)
        and np.linalg.det(u) * np.linalg.det(vt) < 0
    ):
        d[-1] = -1
    rot = u @ np.diag(d) @ vt
    var_s = (sc ** 2).sum() / n
    scale = 1.0 if var_s == 0 else (s * d).sum() / var_s
    t = mu_d - scale * (rot @ mu_s)
    out = np.empty((2, 3), dtype=np.float64)
    out[:, :2] = scale * rot
    out[:, 2] = t
    return out


def make_dlib_landmark_fn(detection_path: str, landmark5_path: str,
                          only_keep_largest: bool = False,
                          upsample_num_times: int = 1) -> Callable:
    """Build a landmark function from dlib model files (reference
    ``init_dlib``/``detect_faces``/``get_face_landmarks_5``,
    ``face_util.py:46-100``). Requires the optional ``dlib`` package."""
    import dlib  # optional dependency — import error surfaces to caller

    detector = dlib.cnn_face_detection_model_v1(detection_path)
    predictor = dlib.shape_predictor(landmark5_path)

    def landmark_fn(img_rgb: np.ndarray) -> List[np.ndarray]:
        dets = detector(img_rgb, upsample_num_times)
        if only_keep_largest and len(dets) > 1:
            areas = [
                (d.rect.right() - d.rect.left())
                * (d.rect.bottom() - d.rect.top())
                for d in dets
            ]
            dets = [dets[int(np.argmax(areas))]]
        out = []
        for det in dets:
            shape = predictor(img_rgb, det.rect)
            out.append(
                np.array([[p.x, p.y] for p in shape.parts()], np.float64))
        return out

    return landmark_fn


class FaceRestorationHelper:
    """Crop-restore-paste pipeline for face images.

    Same call surface as the reference helper (``face_util.py:22-223``):
    ``detect_faces`` -> ``warp_crop_faces`` -> (run the restorer on
    ``cropped_faces``, ``add_restored_face`` each) ->
    ``paste_faces_to_input_image`` -> ``clean_all``.
    """

    def __init__(self, upscale_factor: int, face_size: int = 512,
                 landmark_fn: Optional[Callable] = None):
        self.upscale_factor = int(upscale_factor)
        self.face_size = (int(face_size), int(face_size))
        # reference scales the 1024-template by integer division
        # (face_util.py:36) — preserved verbatim
        self.face_template = FFHQ_TEMPLATE_1024 / (1024 // int(face_size))
        self.landmark_fn = landmark_fn
        self.save_png = True
        self.input_img: Optional[np.ndarray] = None
        self.clean_all()

    # -- detection -------------------------------------------------------
    def read_input_image(self, img_path: str) -> None:
        from lowlight_image_enhancement_tpu_torch.utils import imgio

        img = imgio.imread(img_path)
        if img.dtype == np.uint16:
            img = (img // 257).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        self.input_img = np.ascontiguousarray(img[..., :3])

    def set_input_image(self, img_rgb: np.ndarray) -> None:
        """Array-input alternative to :meth:`read_input_image`."""
        self.input_img = np.asarray(img_rgb)

    def set_landmarks_5(self, landmarks: Sequence[np.ndarray]) -> int:
        """Supply precomputed 5-point landmarks (one ``[5, 2]`` array per
        face) — the no-detector path."""
        self.all_landmarks_5 = [np.asarray(lm, np.float64)
                                for lm in landmarks]
        return len(self.all_landmarks_5)

    def detect_faces(self, img_path: Optional[str] = None) -> int:
        """Detect faces and fill ``all_landmarks_5`` via ``landmark_fn``."""
        if img_path is not None:
            self.read_input_image(img_path)
        if self.input_img is None:
            raise RuntimeError("no input image — call read_input_image or "
                               "set_input_image first")
        if self.landmark_fn is None:
            raise RuntimeError(
                "no landmark detector configured. Pass landmark_fn= (e.g. "
                "make_dlib_landmark_fn(...) when dlib models are available) "
                "or supply landmarks via set_landmarks_5().")
        self.all_landmarks_5 = list(self.landmark_fn(self.input_img))
        if not self.all_landmarks_5:
            print("No face detected.")
        return len(self.all_landmarks_5)

    # -- alignment -------------------------------------------------------
    def warp_crop_faces(self, save_cropped_path: Optional[str] = None,
                        save_inverse_affine_path: Optional[str] = None
                        ) -> None:
        """Estimate per-face affines, warp-crop faces, and the inverse
        affines for paste-back (reference ``face_util.py:139-174``)."""
        from lowlight_image_enhancement_tpu_torch.utils import imgio, imgproc

        for idx, landmark in enumerate(self.all_landmarks_5):
            affine = estimate_similarity(landmark, self.face_template)
            self.affine_matrices.append(affine)
            cropped = imgproc.warp_affine(self.input_img, affine,
                                          self.face_size)
            self.cropped_faces.append(cropped)
            if save_cropped_path is not None:
                path, ext = os.path.splitext(save_cropped_path)
                ext = ".png" if self.save_png else ext
                imgio.imwrite(f"{path}_{idx:02d}{ext}", cropped)
            inverse = estimate_similarity(
                self.face_template, landmark * self.upscale_factor)
            self.inverse_affine_matrices.append(inverse)
            if save_inverse_affine_path is not None:
                path, _ = os.path.splitext(save_inverse_affine_path)
                np.save(f"{path}_{idx:02d}.npy", inverse)

    def add_restored_face(self, face: np.ndarray) -> None:
        """Queue a restored face for paste-back — **RGB**, same order as
        ``cropped_faces`` (deviation from the reference, whose composite
        is BGR as a cv2 artifact; ``face_util.py:176-186``)."""
        self.restored_faces.append(np.asarray(face))

    # -- compositing -----------------------------------------------------
    def paste_faces_to_input_image(self, save_path: Optional[str] = None
                                   ) -> np.ndarray:
        """Inverse-warp restored faces over the upscaled input with an
        eroded, Gaussian-feathered mask (reference ``face_util.py:180-215``).
        Returns the composite (uint8, **RGB**; the reference returns BGR)."""
        from lowlight_image_enhancement_tpu_torch.utils import imgio, imgproc

        h, w, _ = self.input_img.shape
        h_up, w_up = h * self.upscale_factor, w * self.upscale_factor
        upsample_img = imgproc.resize_bilinear(
            self.input_img, (w_up, h_up)).astype(np.float32)
        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError(
                "length of restored_faces and affine_matrices differ")
        for restored, inverse in zip(self.restored_faces,
                                     self.inverse_affine_matrices):
            inv_restored = imgproc.warp_affine(restored, inverse,
                                               (w_up, h_up))
            mask = np.ones((*self.face_size, 3), dtype=np.float32)
            inv_mask = imgproc.warp_affine(mask, inverse, (w_up, h_up))
            k = 2 * self.upscale_factor
            inv_mask_erosion = imgproc.erode(inv_mask, k)
            inv_restored = inv_mask_erosion * inv_restored
            total_face_area = np.sum(inv_mask_erosion) // 3
            # fusion edge width scales with the face area (reference
            # ``face_util.py:200-207``)
            w_edge = int(total_face_area ** 0.5) // 20
            if w_edge > 0:
                r = w_edge * 2
                inv_mask_center = imgproc.erode(inv_mask_erosion, r)
                inv_soft_mask = imgproc.gaussian_blur(inv_mask_center, r + 1)
            else:
                inv_soft_mask = inv_mask_erosion
            upsample_img = (inv_soft_mask * inv_restored
                            + (1 - inv_soft_mask) * upsample_img)
        out = np.clip(upsample_img, 0, 255).astype(np.uint8)
        if save_path is not None:
            if self.save_png:
                save_path = (save_path.replace(".jpg", ".png")
                             .replace(".jpeg", ".png"))
            imgio.imwrite(save_path, out)
        return out

    def clean_all(self) -> None:
        self.all_landmarks_5: List[np.ndarray] = []
        self.affine_matrices: List[np.ndarray] = []
        self.inverse_affine_matrices: List[np.ndarray] = []
        self.cropped_faces: List[np.ndarray] = []
        self.restored_faces: List[np.ndarray] = []
