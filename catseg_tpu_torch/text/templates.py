"""Prompt-template sets for text-embedding ensembling.

These string lists are *data* defining model behavior, originally from
OpenAI's Prompt_Engineering_for_ImageNet notebook (IMAGENET_*), ViLD, and the
reference fork's remote-sensing prompt studies (reference:
cat_seg/third_party/imagenet_templates.py).  Resolution order matches the
reference predictor (cat_seg/modeling/transformer/cat_seg_predictor.py:80-87):
``single`` is what every released CAT-Seg config uses at forward time.

The port's own copy of catseg_tpu/text/templates.py.
"""

SINGLE = ("A photo of a {} in the scene",)

IMAGENET_SELECT = (
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
    "A photo of a {} in the scene",
)

IMAGENET = (
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a sculpture of a {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of the {}.",
    "a rendering of a {}.",
    "graffiti of a {}.",
    "a bad photo of the {}.",
    "a cropped photo of the {}.",
    "a tattoo of a {}.",
    "the embroidered {}.",
    "a photo of a hard to see {}.",
    "a bright photo of a {}.",
    "a photo of a clean {}.",
    "a photo of a dirty {}.",
    "a dark photo of the {}.",
    "a drawing of a {}.",
    "a photo of my {}.",
    "the plastic {}.",
    "a photo of the cool {}.",
    "a close-up photo of a {}.",
    "a black and white photo of the {}.",
    "a painting of the {}.",
    "a painting of a {}.",
    "a pixelated photo of the {}.",
    "a sculpture of the {}.",
    "a bright photo of the {}.",
    "a cropped photo of a {}.",
    "a plastic {}.",
    "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.",
    "a photo of the {}.",
    "a good photo of the {}.",
    "a rendering of the {}.",
    "a {} in a video game.",
    "a photo of one {}.",
    "a doodle of a {}.",
    "a close-up photo of the {}.",
    "a photo of a {}.",
    "the origami {}.",
    "the {} in a video game.",
    "a sketch of a {}.",
    "a doodle of the {}.",
    "a origami {}.",
    "a low resolution photo of a {}.",
    "the toy {}.",
    "a rendition of the {}.",
    "a photo of the clean {}.",
    "a photo of a large {}.",
    "a rendition of a {}.",
    "a photo of a nice {}.",
    "a photo of a weird {}.",
    "a blurry photo of a {}.",
    "a cartoon {}.",
    "art of a {}.",
    "a sketch of the {}.",
    "a embroidered {}.",
    "a pixelated photo of a {}.",
    "itap of the {}.",
    "a jpeg corrupted photo of the {}.",
    "a good photo of a {}.",
    "a plushie {}.",
    "a photo of the nice {}.",
    "a photo of the small {}.",
    "a photo of the weird {}.",
    "the cartoon {}.",
    "art of the {}.",
    "a drawing of the {}.",
    "a photo of the large {}.",
    "a black and white photo of a {}.",
    "the plushie {}.",
    "a dark photo of a {}.",
    "itap of a {}.",
    "graffiti of the {}.",
    "a toy {}.",
    "itap of my {}.",
    "a photo of a cool {}.",
    "a photo of a small {}.",
    "a tattoo of the {}.",
)

# remote-sensing sets from the reference fork
RS = (
    "a photo of a {} in the scene",
    "a remote sensing photo of {}",
    "a land cover scene including {}",
    "an aerial view of {}",
    "a satallite image of {}",
    "fields of {}",
    "a landscape covered with {}",
    "{} visible from above",
)

RS_ALL = (
    "a photo of a {} in the scene",
    "a remote sensing photo of {}",
    "a remote sensing photo of the {} in the background",
    "a remote sensing photo showing {}",
    "a remote sensing photo depicting {}",
    "a remote sensing photo containing {}",
    "a remote sensing scene of {}",
    "a land cover scene including {}",
    "an aerial view of {}",
    "a satallite image featuring {}",
    "a satallite image of {}",
    "fields of {}",
    "a landscape covered with {}",
    "{} visible from above",
)

# ViLD prompt set (63 templates, imagenet_templates.py:406-470).  These use
# {article}/{category} placeholders; format with ``format_template`` below.
VILD = (
    "There is {article} {category} in the scene.",
    "There is the {category} in the scene.",
    "a photo of {article} {category} in the scene.",
    "a photo of the {category} in the scene.",
    "a photo of one {category} in the scene.",
    "itap of {article} {category}.",
    "itap of my {category}.",
    "itap of the {category}.",
    "a photo of {article} {category}.",
    "a photo of my {category}.",
    "a photo of the {category}.",
    "a photo of one {category}.",
    "a photo of many {category}.",
    "a good photo of {article} {category}.",
    "a good photo of the {category}.",
    "a bad photo of {article} {category}.",
    "a bad photo of the {category}.",
    "a photo of a nice {category}.",
    "a photo of the nice {category}.",
    "a photo of a cool {category}.",
    "a photo of the cool {category}.",
    "a photo of a weird {category}.",
    "a photo of the weird {category}.",
    "a photo of a small {category}.",
    "a photo of the small {category}.",
    "a photo of a large {category}.",
    "a photo of the large {category}.",
    "a photo of a clean {category}.",
    "a photo of the clean {category}.",
    "a photo of a dirty {category}.",
    "a photo of the dirty {category}.",
    "a bright photo of {article} {category}.",
    "a bright photo of the {category}.",
    "a dark photo of {article} {category}.",
    "a dark photo of the {category}.",
    "a photo of a hard to see {category}.",
    "a photo of the hard to see {category}.",
    "a low resolution photo of {article} {category}.",
    "a low resolution photo of the {category}.",
    "a cropped photo of {article} {category}.",
    "a cropped photo of the {category}.",
    "a close-up photo of {article} {category}.",
    "a close-up photo of the {category}.",
    "a jpeg corrupted photo of {article} {category}.",
    "a jpeg corrupted photo of the {category}.",
    "a blurry photo of {article} {category}.",
    "a blurry photo of the {category}.",
    "a pixelated photo of {article} {category}.",
    "a pixelated photo of the {category}.",
    "a black and white photo of the {category}.",
    "a black and white photo of {article} {category}.",
    "a plastic {category}.",
    "the plastic {category}.",
    "a toy {category}.",
    "the toy {category}.",
    "a plushie {category}.",
    "the plushie {category}.",
    "a cartoon {category}.",
    "the cartoon {category}.",
    "an embroidered {category}.",
    "the embroidered {category}.",
    "a painting of the {category}.",
    "a painting of a {category}.",
)

SETS: dict[str, tuple[str, ...]] = {
    "single": SINGLE,
    "imagenet": IMAGENET,
    "imagenet_select": IMAGENET_SELECT,
    "rs": RS,
    "rs_all": RS_ALL,
    "vild": VILD,
}


def get(name: str) -> tuple[str, ...]:
    try:
        return SETS[name]
    except KeyError:
        raise NotImplementedError(f"unknown prompt ensemble type {name!r}; known: {sorted(SETS)}")


def format_template(template: str, name: str) -> str:
    """Fill a template with a class name.  ``{}``-style sets use str.format;
    ViLD-style sets carry {article}/{category} placeholders, with the article
    chosen by the vowel rule."""
    if "{category}" in template:
        article = "an" if name[:1].lower() in "aeiou" else "a"
        return template.replace("{article}", article).replace("{category}", name)
    return template.format(name)
